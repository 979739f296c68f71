"""The farmer two-stage stochastic program (Birge and Louveaux; reference
parapint examples/stochastic.py:20-124) as a user of the port hands it
over: its scenarios' yields and probabilities, built into a
``StochasticSchurComplementInteriorPointInterface`` by the port's own
``examples/stochastic.py::build_spec``.

The worked example of a configuration on a second interface
(``benchmark/README.md``): the tests drive it through the harness.  A member
is one draw of the scenarios' yields from the configuration's
``yield_family``: the average yields scaled across the family's range, times
1 + noise * N(0, 1) from a generator seeded with the member's
``noise_seed``; equal probabilities.  Noise seed 0 gives the scenarios of
the port's ``farmer_family(num_scenarios)``.
"""

import numpy as np

# the configuration's sizes cut to what a test process holds on the CPU
TINY = dict(num_scenarios=4)


def _member(config: dict, noise_seed: int) -> dict:
    fam, N = config["yield_family"], config["num_scenarios"]
    rng = np.random.default_rng(noise_seed)
    scale = np.linspace(*fam["scale"], N)[:, None]
    yields = np.asarray(fam["average"])[None, :] * scale * (1.0 + fam["noise"] * rng.standard_normal((N, 3)))
    return {"noise_seed": noise_seed, "yields": yields, "probs": np.full(N, 1.0 / N)}


def instances(config: dict) -> list:
    """The fixed set: one member for each noise seed of the family's ``set``."""
    return [_member(config, s) for s in config["yield_family"]["set"]]


def drawn(config: dict, seed: int) -> dict:
    """The member whose noise seed is ``|seed|``."""
    return _member(config, abs(int(seed)))


def member_params(member: dict) -> dict:
    return {"noise_seed": member["noise_seed"]}


def build_interface(config: dict, member: dict, traffic: dict, device):
    """The port's stochastic interface over ``member``'s scenarios, in the
    configuration's KKT precision (its block form is dense: the traffic's
    ``block_form``, if any, does not apply)."""
    import torch

    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import stochastic

    spec = stochastic.build_spec(yields=member["yields"], probs=member["probs"], device=device)
    return ptt.StochasticSchurComplementInteriorPointInterface(
        spec, kkt_dtype=getattr(torch, config["kkt_dtype"])
    )
