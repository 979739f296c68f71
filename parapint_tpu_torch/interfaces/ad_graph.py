"""CUDA-graph replay of the structured interfaces' per-iteration AD calls.

In the fused interior-point solve, ``eval_ad``, ``convergence_from_ad`` and
``kkt_from_ad`` of the banded block form run hundreds of small kernels each,
at static shapes and with no host synchronisation; on the card their cost is
the host's, one launch after another.  :class:`ADGraphs` captures each of
them once per interface into a CUDA graph and replays it.

- When: the interface decides (``StructuredSCInterface._graphed``) from what
  it can observe: inside :func:`fused_solve_scope` (entered by
  ``make_fused_ip_solve``), on a device :data:`CAPTURE` has a capture for
  (CUDA), without a mesh (whose gather runs collectives), in the banded
  form.  Every other call runs the eager code.
- Inputs: every tensor among a call's arguments is copied, device to device,
  into a static buffer the graph reads, unless it is a store already (the
  ``ad`` that ``eval_ad``'s graph returned), which the graph then reads in
  place.  What a capture bakes in from the host (the arguments' structure
  and numbers, shapes and dtypes, and the interface's ``obj_factor``) is
  the graph's key.  A call off its graph's key runs eagerly; a key that
  two calls in a row bring is captured anew.  Nothing stale is replayed.
- Outputs: the graph ends by copying its outputs into a store, allocated
  outside capture and shared by every graph of that method whose outputs
  have the same shapes and dtypes.  What the method returns aliases the
  store and holds until the next engaged call of the method with that
  signature, of any interface.  The static inputs are shared the same way
  (every engaged call loads all of its own first).  Every graph captures
  into one memory pool, so the captures' transients share one region.
  Buffers and pool go with the last graph that holds them.
- Counters (``utils/profile.py``): each engaged call adds one to
  ``ad_graph.capture``, ``ad_graph.replay`` or ``ad_graph.eager`` and to
  the same name with ``.<method>`` appended.

A replay runs the eager call's kernels on the same inputs, so its outputs
equal the eager ones bit for bit.
"""

import contextlib
import dataclasses
import weakref

import torch

from parapint_tpu_torch.utils.profile import count, host_sync

_depth = 0  # open fused_solve_scope() blocks


@contextlib.contextmanager
def fused_solve_scope():
    """Context manager: the span of one fused solve, whose AD calls may
    replay graphs."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def in_fused_solve() -> bool:
    return _depth > 0


# -- trees of tensors ----------------------------------------------------------

_LEAF = object()  # a tensor's place in a tree's spec


def _flatten(tree, leaves: list):
    """The spec of ``tree`` (its containers and non-tensor values), its
    tensors appended to ``leaves``.  Containers: dicts, lists, tuples and
    dataclasses (IPState, Bounds, BlockRhs, ConvergenceInfo)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = dataclasses.fields(tree)
        return (type(tree), tuple((f.name, _flatten(getattr(tree, f.name), leaves)) for f in fields))
    return tree


def _unflatten(spec, leaves):
    """The tree of ``spec`` with the tensors of the iterator ``leaves``."""
    if spec is _LEAF:
        return next(leaves)
    if not isinstance(spec, tuple):
        return spec
    kind, kids = spec
    if kind in (list, tuple):
        return kind(_unflatten(s, leaves) for s in kids)
    return kind(**{k: _unflatten(s, leaves) for k, s in kids})


def _signature(t: torch.Tensor):
    return t.shape, t.stride(), t.dtype, t.device


# -- shared buffers and pool ---------------------------------------------------

_buffers = weakref.WeakValueDictionary()  # (name, signature) -> tensor
_stores = weakref.WeakValueDictionary()  # id -> every output store tensor


def _buffer(name, like: torch.Tensor) -> torch.Tensor:
    """The buffer ``name`` shaped like ``like``, shared by every graph that
    asks for it while one holds it."""
    key = (name, _signature(like))
    buf = _buffers.get(key)
    if buf is None:
        buf = _buffers[key] = torch.empty_like(like)
    return buf


def _store(method: str, i: int, like: torch.Tensor) -> torch.Tensor:
    buf = _buffer((method, i), like)
    _stores[id(buf)] = buf
    return buf


def _input(i: int, leaf: torch.Tensor) -> torch.Tensor:
    """The static input of argument tensor ``i``: ``leaf`` itself where it is
    a store, else the shared buffer of its place and signature."""
    if _stores.get(id(leaf)) is leaf:
        return leaf
    return _buffer(("in", i), leaf)


def _load(inputs, leaves) -> None:
    for buf, leaf in zip(inputs, leaves):
        if buf is not leaf:
            buf.copy_(leaf)


_pool = lambda: None  # a weak reference to the pool every graph shares
_streams = {}  # device -> the side stream graphs warm up and capture on


@dataclasses.dataclass(eq=False)
class _PoolHandle:
    handle: tuple


def _shared_pool() -> _PoolHandle:
    global _pool
    pool = _pool()
    if pool is None:
        # a new id once the last graph of the old pool has gone: torch takes
        # no pool id back after its graphs are freed
        pool = _PoolHandle(torch.cuda.graph_pool_handle())
        _pool = weakref.ref(pool)
    return pool


@dataclasses.dataclass
class _CudaGraph:
    graph: object  # torch.cuda.CUDAGraph
    pool: _PoolHandle  # held while the graph lives

    def __call__(self):
        self.graph.replay()


def _cuda_capture(call, make_store):
    """Warm ``call`` up on a side stream, then capture it into a CUDA graph
    in the shared pool, ending in copies of its outputs into the store that
    ``make_store`` allocates from the warm-up's outputs.  Returns (store,
    replay)."""
    main = torch.cuda.current_stream()
    side = _streams.get(main.device)
    if side is None:
        side = _streams[main.device] = torch.cuda.Stream(main.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        outs = call()
    main.wait_stream(side)
    store = make_store(outs)
    del outs
    pool = _shared_pool()
    graph = torch.cuda.CUDAGraph()
    with host_sync():  # capture starts from an idle card
        torch.cuda.synchronize(main.device)
    # cuBLAS holds a workspace (32 MiB on an H100) for every stream it ran
    # on.  Dropped before and after the capture, the side stream's is
    # allocated inside the capture, in the pool, a transient like the
    # graphs' others, instead of held for good beside the main stream's
    # (which is allocated again at its next use); torch's CUDA-graph trees
    # do the same
    torch._C._cuda_clearCublasWorkspaces()
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool.handle)
        try:
            for buf, out in zip(store, call()):
                buf.copy_(out)
        finally:
            graph.capture_end()
    torch._C._cuda_clearCublasWorkspaces()
    return store, _CudaGraph(graph, pool)


# device type -> capture(call, make_store) -> (store, replay)
CAPTURE = {"cuda": _cuda_capture}


# -- one interface's graphs ----------------------------------------------------


@dataclasses.dataclass
class _Graph:
    key: tuple
    inputs: list  # the static input of each argument tensor
    spec: object  # the outputs' spec
    store: list  # the outputs' store
    replay: object


class ADGraphs:
    """The captured AD calls of one interface, one graph per method."""

    def __init__(self, device: torch.device):
        self._device_type = device.type
        self._graphs = {}
        self._last_key = {}

    def __call__(self, method: str, fn, args: tuple, host_key=()):
        """``fn(*args)``, the body of ``method``, by its graph (module
        docstring); ``host_key`` holds what ``fn`` reads from the host
        besides its arguments."""
        leaves = []
        spec = _flatten(args, leaves)
        key = (spec, tuple(_signature(t) for t in leaves), host_key)
        graph = self._graphs.get(method)
        if graph is not None and graph.key == key:
            kind = "replay"
        elif graph is None or self._last_key.get(method) == key:
            kind = "capture"
        else:
            kind = "eager"
        self._last_key[method] = key
        count(f"ad_graph.{kind}")
        count(f"ad_graph.{kind}.{method}")
        if kind == "eager":
            return fn(*args)
        if kind == "capture":
            self._graphs.pop(method, None)
            graph = self._graphs[method] = self._capture(method, fn, spec, leaves, key)
        else:
            _load(graph.inputs, leaves)
        graph.replay()
        return _unflatten(graph.spec, iter(graph.store))

    def _capture(self, method, fn, spec, leaves, key) -> _Graph:
        inputs = [_input(i, t) for i, t in enumerate(leaves)]
        _load(inputs, leaves)
        static_args = _unflatten(spec, iter(inputs))
        out_spec = []

        def call():
            outs = []
            out_spec[:] = [_flatten(fn(*static_args), outs)]
            return outs

        def make_store(outs):
            return [_store(method, i, t) for i, t in enumerate(outs)]

        store, replay = CAPTURE[self._device_type](call, make_store)
        return _Graph(key, inputs, out_spec[0], store, replay)
