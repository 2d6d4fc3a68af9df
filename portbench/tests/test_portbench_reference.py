"""The plain reference against the port on the CPU, at small widths of
the two cells' shapes, float32: the port's cache-free forward and its
served tokens, on the benchmark's own weights.  Each test configuration
under ``data/`` whose architecture is one of ``portbench/reference``'s
is a case."""
import json
from pathlib import Path

import pytest
import torch

from portbench.harness import drive, spec, weights

DATA = Path(__file__).parent / "data"
REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def _config(name: str) -> dict:
    with open(DATA / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def _served_configs() -> list:
    """The test configurations the program serves: those whose
    architecture has its module in ``portbench/reference``."""
    out = []
    for path in sorted(DATA.glob("*.json")):
        c = _config(path.stem)
        arch = c.get("architecture", "decoder")
        if "model" in c and (REFERENCE / f"{arch}.py").is_file():
            out.append(path.stem)
    return out


SERVED = _served_configs()


def _arch_and_model(name: str) -> tuple:
    c = _config(name)
    return spec.architecture(c), c["model"]


@pytest.mark.parametrize("name", SERVED)
def test_reference_matches_port_forward(name):
    from repro_torch.models.lm import LM, Runtime
    arch, m = _arch_and_model(name)
    params = weights.make(arch, m, 2**31 + 17, "cpu")
    port = LM(drive.model_config(m), Runtime(), device="cpu")
    tokens = torch.randint(0, m["vocab"], (2, 24),
                           generator=torch.Generator().manual_seed(3))
    want = port.forward(params, tokens)
    rows = [torch.arange(24)] * 2
    got = arch.logits(m, params, list(tokens), rows).reshape(2, 24, -1)
    assert (got - want).abs().max().item() < 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("name", SERVED)
def test_control_departs_from_reference(name):
    """The float8 control computes other logits, further from the
    float32 reference than float32 rounding is."""
    arch, m = _arch_and_model(name)
    params = weights.make(arch, m, 5, "cpu")
    seq = [torch.randint(0, m["vocab"], (40,),
                         generator=torch.Generator().manual_seed(1))]
    rows = [torch.arange(40)]
    ref = arch.logits(m, params, seq, rows)
    low = arch.logits(m, params, seq, rows, fp8=True)
    rel = ((low - ref).norm() / ref.norm()).item()
    assert 1e-3 < rel < 0.5


@pytest.mark.parametrize("name", SERVED)
def test_weights_take_the_ports_layout(name):
    from repro_torch import tree as T
    from repro_torch.models.lm import LM
    arch, m = _arch_and_model(name)
    got = weights.make(arch, m, 1, "cpu")
    want = LM(drive.model_config(m), device="meta").abstract_params()
    assert sorted(k for k, _ in T.leaves_with_paths(got)) == \
        sorted(k for k, _ in T.leaves_with_paths(want))
    shapes = T.map_tree(lambda a, b: (tuple(a.shape), a.dtype)
                        == (tuple(b.shape), b.dtype), got, want)
    assert all(T.leaves(shapes))


def test_weights_repeat_per_seed():
    arch, m = _arch_and_model("tiny-moe")
    a, b = weights.make(arch, m, 99, "cpu"), weights.make(arch, m, 99, "cpu")
    c = weights.make(arch, m, 100, "cpu")
    assert torch.equal(a["layers"][1]["ff"]["w_up"], b["layers"][1]["ff"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])
