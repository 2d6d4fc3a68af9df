"""An architecture is files of its own: a module found by the name a
configuration file gives (``spec.architecture``), and nothing else.
What the move of the ``decoder`` into its module must not change (its
weights, reference logits and counts, captured before the move in
``data/before-the-move.json``), a test-only architecture
(``data/interleaved.py``) found through ``where`` and used for weights,
reference, counts and attention layers, and the program's config built
from a file's ``model`` for every architecture the program has."""
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import check, drive, spec, weights
from portbench.harness.drive import Run, Served, StepRec
from portbench.harness.trace import Trace
from portbench.harness.traffic import Request

HERE = Path(__file__).resolve().parent
DATA = HERE / "data"
ROOT = HERE.parents[1]
BEFORE = json.loads((DATA / "before-the-move.json").read_text())


def _config(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()) \
        .hexdigest()


@pytest.mark.parametrize("name", sorted(BEFORE["configs"]))
def test_weights_and_reference_as_before_the_move(name):
    from repro_torch import tree as T
    c = _config(name)
    arch, m = spec.architecture(c), c["model"]
    want = BEFORE["configs"][name]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed in BEFORE["seeds"]:
            got = {k: _digest(v) for k, v in T.leaves_with_paths(
                weights.make(arch, m, seed, "cpu"))}
            assert got == want["weights"][str(seed)]
        params = weights.make(arch, m, BEFORE["seeds"][0], "cpu")
        toks = torch.tensor(want["tokens"])
        rows = [torch.arange(len(toks))]
        for key, fp8 in (("f32", False), ("fp8", True)):
            lg = arch.logits(m, params, [toks], rows, fp8=fp8)
            assert _digest(lg) == want["logits"][key], key
    finally:
        torch.set_num_threads(threads)


def test_a_missing_architecture_names_its_file():
    with pytest.raises(SystemExit, match="nowhere.py"):
        spec.architecture({"architecture": "nowhere"}, where=DATA)


def test_a_new_architecture_is_found_through_where(tmp_path):
    """A configuration naming ``interleaved`` gets the module under
    ``data/`` in ``load_cell``, and its attention layers are fewer than
    its layers."""
    bench = {"configs": [{"name": "tiny", "file": str(
                (DATA / "tiny-interleaved.json").relative_to(ROOT))}],
             "workloads": [{"name": "olmoe-reasoning", "config": "tiny",
                            "traffic": "reasoning-c48", "chips": 1}],
             "end_to_end": [], "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("olmoe-reasoning", tmp_path / "BENCHMARK.json",
                          where=DATA)
    assert cell.arch.__file__ == str(DATA / "interleaved.py")
    m = cell.config["model"]
    assert cell.arch.attention_layers(m) == 2 < m["n_layers"]


def _greedy(arch, m, params, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        lg = arch.logits(m, params, [torch.tensor(seq)],
                         [torch.tensor([len(seq) - 1])])
        seq.append(int(lg.argmax()))
    return seq[len(prompt):]


def test_a_new_architecture_makes_weights_reference_and_counts():
    c = _config("tiny-interleaved")
    arch, m = spec.architecture(c, where=DATA), c["model"]
    params = weights.make(arch, m, 2**31 + 5, "cpu")
    assert "mix" not in params["layers"][0] and "ln1" not in \
        params["layers"][0]
    assert params["layers"][1]["mix"]["wq"].shape == (64, 64)
    # check.gaps reads the architecture's reference: its own greedy
    # tokens lie on its best logit, other tokens below it
    prompt = np.arange(3, 15, dtype=np.int64)
    toks = _greedy(arch, m, params, prompt, 6)
    s = Served(Request(prompt, 6, len(prompt)), 0, 0.0, None, tokens=toks)
    got, ctl, _ = check.gaps(arch, m, params, [s], fp8_control=True)
    assert got.numel() == 6 and got.max().item() < 1e-5
    assert ctl is not None and ctl.numel() == 6
    s.tokens = [(t + 1) % m["vocab"] for t in toks]
    assert check.gaps(arch, m, params, [s])[0].min().item() > 0
    # counts: an architecture with attention in every layer counts as
    # the decoder does; here half the layers add no attention
    decoder = spec.architecture({})
    every = dict(m, pattern=["attn"])
    assert arch.decode_flops(every, 300) == decoder.decode_flops(m, 300)
    assert arch.prefill_flops(every, 37) == decoder.prefill_flops(m, 37)
    attn = decoder.proj_flops(m) + decoder.attn_core_flops(m, 300)
    assert arch.decode_flops(m, 300) == pytest.approx(
        decoder.decode_flops(m, 300) - 2 * attn)


def _window(cell) -> Run:
    steps = [StepRec(0.0, 0.02, [], [100, 300, 2000], 3, traced=True),
             StepRec(0.02, 0.04, [], [101, 301, 2001], 3, traced=True)]
    trace = Trace(0.04, 0.03, {"void attn_partial_kernel<bf16, true>(x)":
                               0.004, "attn_merge_kernel": 0.001}, {})
    return Run(cell, cell.config["model"], 1.0, 0.0, 1.0, steps, steps,
               [], {}, {}, set(), trace)


def test_attn_partial_roofline_reads_the_attention_layers():
    c = _config("tiny-interleaved")
    read = spec.reader("attn_partial_roofline")
    mine = spec.Cell("tiny", c, {}, {}, [], [], {},
                     spec.architecture(c, where=DATA))
    as_decoder = spec.Cell("tiny", c, {}, {}, [], [], {},
                           spec.architecture({}))
    full = read(_window(as_decoder))
    assert full > 0
    assert read(_window(mine)) == pytest.approx(full * 2 / 4)


def _configs():
    from repro_torch import configs
    return [(a, smoke) for a in configs.ARCHS for smoke in (False, True)]


@pytest.mark.parametrize("arch,smoke", _configs())
def test_model_config_round_trips(arch, smoke):
    """Every FULL and SMOKE config of ``repro_torch.configs``, written
    out as a configuration file's ``model`` would be, builds the same
    ``ModelConfig``: ``pattern`` a tuple, ``moe`` / ``ssm`` / ``rglru``
    / ``encoder`` their dataclasses."""
    from repro_torch import configs
    cfg = configs.get_config(arch, smoke=smoke)
    m = json.loads(json.dumps(dataclasses.asdict(cfg)))
    got = drive.model_config(m)
    assert got == cfg
    assert isinstance(got.pattern, tuple)
    for f in ("moe", "ssm", "rglru", "encoder"):
        assert type(getattr(got, f)) is type(getattr(cfg, f))
