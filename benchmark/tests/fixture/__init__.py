"""A configuration on a second interface of the port: the farmer two-stage
stochastic program, laid out as a configuration of the benchmark is
(``configs/``, ``models/``, ``reference/``, ``traffic/``), for the tests
to drive through the harness.  It is no cell of ``BENCHMARK.json``."""

import importlib
import json
from pathlib import Path

DIR = Path(__file__).resolve().parent
CONFIG = "farmer_4scenarios"
TRAFFIC = "dense_schur"
CELL = f"{CONFIG}.{TRAFFIC}"


def config() -> dict:
    return json.loads((DIR / "configs" / f"{CONFIG}.json").read_text())


def traffic() -> dict:
    return json.loads((DIR / "traffic" / f"{TRAFFIC}.json").read_text())


def model_module(config: dict):
    return importlib.import_module(f"{__name__}.models.{config['model']}")


def reference_module(config: dict):
    return importlib.import_module(f"{__name__}.reference.{config['model']}")
