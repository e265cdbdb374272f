"""The control: the reference in the program's place with one guarantee
of the configuration broken comes out not correct, on three seeds, at a
size a test run holds (the chip runs it at the cells' own size)."""

import json
import os

import pytest

from kmebench import spec as S
from kmebench.control import readings

# every configuration file, those that wait outside BENCHMARK.json too
CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(S.HERE, "configs")))


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", [11, 2**31 + 3, 4_000_000_001])
def test_the_control_is_not_correct(config, seed):
    cfg = json.load(open(os.path.join(S.HERE, "configs", config + ".json")))
    r = readings(cfg, seed, 40_000)
    assert r["records_differing"] > 0
    assert r["first_difference"] is not None
