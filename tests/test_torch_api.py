"""The port's public API against the JAX package's, argument by argument.

For every module of ``parapint_tpu`` that has a counterpart of the same
dotted name in ``parapint_tpu_torch``: every public function and class the
JAX module defines exists in the port's module; every public attribute of
such a class (method, property, class attribute, enum member) exists on the
port's class; and every parameter of the JAX callable (a function, a
class's constructor, a method) is a parameter of the port's with an equal
default.  A JAX dtype default equals the torch dtype of the same name.  A
JAX property may be a plain instance attribute in the port (assigned as
``self.<name> = ...`` in its class).  This extends
``tests/test_torch_results.py::test_port_has_every_jax_name`` (the
structured interfaces' names) to the whole package and to the parameters.

The only exceptions are the JAX- or TPU-only names of ``EXEMPT`` and the
launcher words of ``RENAMED``, each with its reason; an exempted name that
the port has after all fails the test, so the table cannot go stale.
"""

import enum
import importlib
import inspect
import pkgutil
import re

import numpy as np
import pytest
import torch

import parapint_tpu
import parapint_tpu_torch

# JAX-package names the port does not carry, with the reason: a module
# (dotted path), a module-level name or a class attribute
# ("module.Class.attr"), or a parameter ("module.callable(param)")
EXEMPT = {
    "ops.pallas_ldl": "the Pallas TPU kernels; their CUDA counterparts K1-K5 sit behind the "
                      "same entry names in ops/ldl_panel.py",
    "native": "the JAX package's prebuilt host LDL^T library; the port builds "
              "csrc/bk_ldl.cpp itself (linalg/host_bk.py)",
    "ops.winv_apply.available": "whether Pallas-TPU is present; the port's wrapper launches its "
                                "kernel on every CUDA tensor",
    "ops.winv_apply.apply_chunk_default": "the TPU kernel's VMEM chunking; VMEM models are "
                                          "dropped, not ported (ROADMAP)",
    "linalg.tridiag.BlockTridiagSolver.fact_struct": "the abstract factor pytree for "
                                                     "shard_map's out_specs",
    "parallel.distributed.replicated_to_global": "places a host array as a jax.Array on a "
                                                 "multi-host mesh; torch ranks hold plain tensors",
    "linalg.banded_schur.BandedSchurFactor(sym_bands)": "a factor record field produced by "
                                                        "numeric, never built by a user; the "
                                                        "port's refinement reads its tile store",
    "linalg.condensed.CondensedFactor(s_lam_inv)": "a factor record field produced by numeric, "
                                                   "never built by a user; no port solve reads it",
}
# JAX parameter -> the port's, where torch's launcher words replace
# jax.distributed's
RENAMED = {
    "parallel.distributed.initialize": {
        "coordinator_address": "init_method",
        "num_processes": "world_size",
        "process_id": "rank",
        "local_device_count": "device_type",
    },
}


def _modules(pkg):
    """{dotted name relative to the package: module}, skipping the
    exempted modules and everything under them."""
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        rel = info.name[len(pkg.__name__) + 1:]
        if any(rel == e or rel.startswith(e + ".") for e in EXEMPT):
            continue
        out[rel] = importlib.import_module(info.name)
    return out


JAX_MODULES = _modules(parapint_tpu)


def _port_module(rel):
    try:
        return importlib.import_module("parapint_tpu_torch" + (f".{rel}" if rel else ""))
    except ImportError:
        return None


def _defined(module):
    """The public functions and classes ``module`` defines (not imports)."""
    return {n: obj for n, obj in vars(module).items()
            if not n.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


def _params(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):  # a builtin without a signature
        return None


def _dtype_name(x):
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    if isinstance(x, np.dtype) or (isinstance(x, type) and issubclass(x, np.generic)):
        return np.dtype(x).name
    dtype = getattr(x, "dtype", None)  # jax.numpy's scalar types
    if isinstance(x, type) and isinstance(dtype, np.dtype):
        return dtype.name
    return None


def _same_default(j, t):
    if j is t:
        return True
    if isinstance(j, enum.Enum) or isinstance(t, enum.Enum):  # each package's own enum
        return (type(j).__name__, getattr(j, "name", j)) == (type(t).__name__, getattr(t, "name", t))
    jd, td = _dtype_name(j), _dtype_name(t)
    if jd is not None or td is not None:
        return jd == td
    return type(j) is type(t) and repr(j) == repr(t)


def _assigned_on_instances(cls, name):
    """Whether ``cls`` or a base of it assigns ``self.<name>`` (an instance
    attribute standing for a JAX property)."""
    pattern = re.compile(rf"\bself\.{re.escape(name)}\s*=[^=]")
    for base in cls.__mro__:
        if base.__module__.startswith("parapint_tpu_torch"):
            try:
                if pattern.search(inspect.getsource(base)):
                    return True
            except (OSError, TypeError):
                pass
    return False


def _attributes(jcls):
    """The public attributes ``jcls`` itself defines: name -> raw value."""
    return {n: v for n, v in vars(jcls).items() if not n.startswith("_")}


def _gaps(rel, jm, tm):
    """Every way the port's module ``tm`` falls short of the JAX module
    ``jm``, as strings naming the place."""
    gaps = []

    def compare(qual, jfn, tfn):
        jp, tp = _params(jfn), _params(tfn)
        if jp is None or tp is None:
            return
        renamed = RENAMED.get(qual, {})
        for name, p in jp.items():
            if f"{qual}({name})" in EXEMPT:
                continue
            tname = renamed.get(name, name)
            if tname not in tp:
                gaps.append(f"{qual}({name}): missing")
            elif name not in renamed and not _same_default(p.default, tp[tname].default):
                gaps.append(f"{qual}({name}): default {p.default!r} != {tp[tname].default!r}")

    for name, jobj in _defined(jm).items():
        qual = f"{rel}.{name}"
        if qual in EXEMPT:
            continue
        tobj = getattr(tm, name, None)
        if tobj is None:
            gaps.append(f"{qual}: missing")
            continue
        compare(qual, jobj, tobj)
        if not inspect.isclass(jobj):
            continue
        for attr, raw in _attributes(jobj).items():
            aqual = f"{qual}.{attr}"
            if aqual in EXEMPT:
                continue
            if not hasattr(tobj, attr):
                if not (isinstance(raw, property) and _assigned_on_instances(tobj, attr)):
                    gaps.append(f"{aqual}: missing")
                continue
            if callable(getattr(jobj, attr)) and not isinstance(raw, property):
                compare(aqual, getattr(jobj, attr), getattr(tobj, attr))
    return gaps


@pytest.mark.parametrize("rel", sorted(JAX_MODULES), ids=lambda r: r or "parapint_tpu")
def test_port_has_every_jax_argument(rel):
    tm = _port_module(rel)
    assert tm is not None, f"parapint_tpu_torch.{rel} is missing"
    gaps = _gaps(rel, JAX_MODULES[rel], tm)
    assert not gaps, "\n".join(gaps)


def _resolve(package, dotted):
    """The object at ``package.dotted`` (a module, or a name inside one
    reached by attributes), or None."""
    head, rest = dotted, []
    while head:
        try:
            obj = importlib.import_module(f"{package}.{head}")
        except ImportError:
            head, _, last = head.rpartition(".")
            rest.insert(0, last)
            continue
        for part in rest:
            obj = getattr(obj, part, None)
            if obj is None:
                return None
        return obj
    return None


def _has(package, entry):
    """Whether ``package`` has the exempted ``entry``."""
    qual, _, param = entry.partition("(")
    obj = _resolve(package, qual)
    if obj is None or not param:
        return obj is not None
    params = _params(obj)
    return params is not None and param[:-1] in params


@pytest.mark.parametrize("entry", sorted(EXEMPT))
def test_exemptions_are_not_stale(entry):
    """Each exempted name exists in the JAX package and not in the port,
    and each has its reason."""
    assert EXEMPT[entry].strip()
    assert _has("parapint_tpu", entry), f"{entry} is not in the JAX package"
    assert not _has("parapint_tpu_torch", entry), f"{entry} is ported now: take it out of EXEMPT"


def test_renamed_launcher_words():
    """``initialize``'s renamed parameters: the JAX names exist there, the
    port's words here, and no JAX name is also a port parameter."""
    from parapint_tpu.parallel import distributed as jd
    from parapint_tpu_torch.parallel import distributed as td

    for qual, names in RENAMED.items():
        assert qual == "parallel.distributed.initialize"
        jp, tp = _params(jd.initialize), _params(td.initialize)
        for jname, tname in names.items():
            assert jname in jp and tname in tp and jname not in tp
