"""The plain reference against the port on the CPU, at small widths of
the two cells' shapes, float32: the port's cache-free forward and its
served tokens, on the benchmark's own weights."""
import json
from pathlib import Path

import pytest
import torch

from portbench.harness import drive, weights
from portbench.reference import decoder

DATA = Path(__file__).parent / "data"


def _model(name: str) -> dict:
    with open(DATA / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_reference_matches_port_forward(name):
    from repro_torch.models.lm import LM, Runtime
    m = _model(name)
    params = weights.make(m, 2**31 + 17, "cpu")
    port = LM(drive.model_config(m), Runtime(), device="cpu")
    tokens = torch.randint(0, m["vocab"], (2, 24),
                           generator=torch.Generator().manual_seed(3))
    want = port.forward(params, tokens)
    rows = [torch.arange(24)] * 2
    got = decoder.logits(m, params, list(tokens), rows).reshape(2, 24, -1)
    assert (got - want).abs().max().item() < 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_control_departs_from_reference(name):
    """The float8 control computes other logits, further from the
    float32 reference than float32 rounding is."""
    m = _model(name)
    params = weights.make(m, 5, "cpu")
    seq = [torch.randint(0, m["vocab"], (40,),
                         generator=torch.Generator().manual_seed(1))]
    rows = [torch.arange(40)]
    ref = decoder.logits(m, params, seq, rows)
    low = decoder.logits(m, params, seq, rows, fp8=True)
    rel = ((low - ref).norm() / ref.norm()).item()
    assert 1e-3 < rel < 0.5


def test_weights_take_the_ports_layout():
    from repro_torch import tree as T
    from repro_torch.models.lm import LM
    for name in ("tiny-dense", "tiny-moe"):
        m = _model(name)
        got = weights.make(m, 1, "cpu")
        want = LM(drive.model_config(m), device="meta").abstract_params()
        shapes = T.map_tree(lambda a, b: (tuple(a.shape), a.dtype)
                            == (tuple(b.shape), b.dtype), got, want)
        assert all(T.leaves(shapes))


def test_weights_repeat_per_seed():
    m = _model("tiny-moe")
    a, b = weights.make(m, 99, "cpu"), weights.make(m, 99, "cpu")
    c = weights.make(m, 100, "cpu")
    assert torch.equal(a["layers"][1]["ff"]["w_up"], b["layers"][1]["ff"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])
