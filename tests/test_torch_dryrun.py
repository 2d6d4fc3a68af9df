"""The port's dry run and what it needs, against the JAX package's on the
CPU: the shape cells, ``model_flops``, the step specs (``input_specs``,
``batch_specs``), ``abstract_params`` and ``abstract_cache`` of every
FULL config leaf by leaf, AdamW's abstract state and its layouts, the
tuner's and the planner's reports under ``V5E``, and ``run_cell``'s
record on a dry 2 x 2 mesh (and the error a hybrid cell records).

Everything here is shapes: the port's side runs on the ``meta``
device, the JAX package's through ``jax.eval_shape``.
"""
import dataclasses
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, ShapeCell,  # noqa: E402
                                 all_cells, cell_applicable, get_config)
from repro_torch.launch import analysis, dryrun, steps  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True)
def _hermetic_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))


def _ref_config(arch):
    from repro.configs import get_config as ref_config
    return ref_config(arch)


def _sds(t) -> tuple:
    """(shape, dtype name) of a jax ShapeDtypeStruct or a tensor."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).replace("torch.", "")
    return tuple(t.shape), str(t.dtype)


def _leaves(tree) -> dict:
    return {k: _sds(v) for k, v in T.leaves_with_paths(tree)}


def _unstack(tree, j):
    """Entry ``j`` of every leaf's leading (scanned) axis, as (shape,
    dtype) pairs."""
    if isinstance(tree, dict):
        return {k: _unstack(v, j) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unstack(v, j) for v in tree]
    shape, dt = _sds(tree)
    return jax.ShapeDtypeStruct(shape[1:], dt)


def _ref_layers(stack, tail, pattern, n_layers):
    """The JAX package's scanned stack and tail in layer order."""
    n_super = n_layers // len(pattern)
    names = (sorted(stack, key=lambda n: int(n.split("_")[0][1:]))
             if isinstance(stack, dict) else range(len(stack)))
    return [_unstack(stack[n], j) for j in range(n_super)
            for n in names] + list(tail)


# ---------------------------------------------------------------------------
# cells and model flops
# ---------------------------------------------------------------------------

def test_cells_match_reference():
    from repro import configs as ref
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}
    assert sorted(all_cells()) == sorted(ref.all_cells())
    assert len(all_cells()) == 33
    assert sorted(a for a, s in all_cells() if s == "long_500k") == [
        "mamba2_1p3b", "mixtral_8x7b", "recurrentgemma_2b"]
    for arch in ARCHS:
        for shape in SHAPES.values():
            assert cell_applicable(get_config(arch), shape) == \
                ref.cell_applicable(_ref_config(arch), ref.SHAPES[shape.name])


@pytest.mark.parametrize("n_dev", [256, 512])
def test_model_flops_match_reference(n_dev):
    from repro.launch.hlo_analysis import model_flops as ref_flops
    from repro import configs as ref
    for arch, shape in all_cells():
        got = analysis.model_flops(get_config(arch), SHAPES[shape], n_dev)
        want = ref_flops(_ref_config(arch), ref.SHAPES[shape], n_dev)
        assert got == pytest.approx(want, rel=1e-12), (arch, shape)


def test_roofline_terms_under_h100():
    from repro_torch.core.perf_model import H100
    from repro_torch.launch.op_cost import CollectiveStats, Cost
    coll = CollectiveStats()
    coll.note("all-reduce", 1000, 4)
    r = analysis.roofline_terms(Cost(989e12, 3.35e12), coll, 494.5e12)
    assert (r.compute_s, r.memory_s) == (pytest.approx(1.0),
                                         pytest.approx(1.0))
    assert r.collective_s == pytest.approx(1500 / H100.ici_bw)
    assert r.useful_ratio == pytest.approx(0.5)
    assert (H100.peak_flops, H100.hbm_bw, H100.ici_bw) == (989e12, 3.35e12,
                                                           450e9)


# ---------------------------------------------------------------------------
# step specs
# ---------------------------------------------------------------------------

def _norm_layout(entry):
    """A layout entry as a tuple of mesh-dim names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_input_and_batch_specs_match_reference(mesh_name):
    from repro import configs as ref
    from repro.dist.sharding import Rules as RefRules
    from repro.launch import steps as ref_steps
    from repro_torch.dist.sharding import Rules
    shape_map = MESHES[mesh_name]
    dp = tuple(n for n in shape_map if n != "model")
    stub = SimpleNamespace(shape=shape_map)
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), _ref_config(arch)
        for name, shape in SHAPES.items():
            got = steps.input_specs(cfg, shape)
            want = ref_steps.input_specs(rcfg, ref.SHAPES[name])
            assert list(got) == list(want), (arch, name)
            for k in got:
                assert got[k].device.type == "meta"
                assert _sds(got[k]) == _sds(want[k]), (arch, name, k)
            gl = steps.batch_specs(cfg, shape, Rules(data=dp, model="model"),
                                   stub)
            wl = ref_steps.batch_specs(rcfg, ref.SHAPES[name],
                                       RefRules(data=dp, model="model"),
                                       stub)
            assert list(gl) == list(wl)
            for k in gl:
                assert [_norm_layout(e) for e in gl[k]] == [
                    _norm_layout(e) for e in tuple(wl[k])], (arch, name, k)


def test_local_specs_give_a_rank_block():
    from repro_torch.dist.collectives import DryMesh
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.dist.sharding import Rules
    cfg = get_config("qwen3-8b")
    mesh = DryMesh({"data": 16, "model": 16})
    model = LM(cfg, Runtime(rules=Rules(data=("data",), model="model",
                                        tp="model"), mesh=mesh),
               device="meta")
    local = steps.local_specs(model.abstract_params(), model.param_specs(),
                              mesh)
    wq = local["layers"][0]["mix"]["wq"]
    assert tuple(wq.shape) == (cfg.d_model // 16,
                               cfg.n_heads * cfg.dh // 16)
    assert tuple(local["embed"].shape) == (cfg.vocab // 16,
                                           cfg.d_model // 16)


# ---------------------------------------------------------------------------
# abstract params, cache and optimizer state
# ---------------------------------------------------------------------------

def _ref_model(arch):
    from repro.launch.steps import build_model
    return build_model(_ref_config(arch))


def _ref_params_in_port_layout(arch, cfg):
    """The JAX package's ``abstract_params`` in the port's tree: its
    stacks unstacked into per-layer dicts."""
    a = _ref_model(arch).abstract_params()
    if cfg.family == "encdec":
        out = {k: a[k] for k in ("enc_pos", "enc_norm", "embed", "dec_pos",
                                 "final_norm")}
        out["enc_layers"] = [_unstack(a["enc_stack"], j)
                             for j in range(cfg.encoder.n_layers)]
        out["dec_layers"] = [_unstack(a["dec_stack"], j)
                             for j in range(cfg.n_layers)]
        return out
    out = {k: a[k] for k in ("embed", "final_norm", "pos_embed", "lm_head")
           if k in a}
    out["layers"] = _ref_layers(a["stack"], a["tail"], cfg.pattern,
                                cfg.n_layers)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    cfg = get_config(arch)
    model = steps.build_model(cfg, device="meta")
    got = model.abstract_params()
    assert all(t.device.type == "meta" for t in T.leaves(got))
    assert _leaves(got) == _leaves(_ref_params_in_port_layout(arch, cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_reference(arch):
    from repro import configs as ref
    cfg = get_config(arch)
    shape = SHAPES["decode_32k"]
    got = steps.abstract_cache(steps.build_model(cfg, device="meta"), cfg,
                               shape)
    rm = _ref_model(arch)
    from repro.launch.steps import abstract_cache as ref_cache
    a = ref_cache(rm, _ref_config(arch), ref.SHAPES["decode_32k"])
    if cfg.family == "encdec":
        want = [_unstack(a, j) for j in range(cfg.n_layers)]
    else:
        want = _ref_layers(a["stack"], a["tail"], cfg.pattern, cfg.n_layers)
    assert _leaves(got) == _leaves(want)


def test_adamw_abstract_state_and_specs_match_reference():
    from repro.launch.steps import default_optimizer as ref_opt
    cfg = get_config("olmoe-1b-7b")
    model = steps.build_model(cfg, device="meta")
    opt = steps.default_optimizer()
    got = opt.abstract_state(model.abstract_params())
    want = ref_opt().abstract_state(
        _ref_params_in_port_layout("olmoe-1b-7b", cfg))
    assert _leaves(got) == _leaves(want)
    specs = opt.state_specs({"w": ("data", "model")})
    assert specs == {"step": (), "m": {"w": ("data", "model")},
                     "v": {"w": ("data", "model")},
                     "master": {"w": ("data", "model")}}
    with pytest.raises(ValueError, match="meta"):
        opt.abstract_state({"w": torch.zeros(2)})


# ---------------------------------------------------------------------------
# the tuner's and the planner's reports, under V5E against the reference
# ---------------------------------------------------------------------------

def test_kernelized_attention_bytes_match_reference():
    """Meshless, and under the stub mesh of
    ``tests/test_schedule_cache.py``'s regime test."""
    from repro.dist.sharding import Rules as RefRules
    from repro.launch.hlo_analysis import kernelized_attention_bytes as ref
    from repro import configs as rc
    from repro_torch.core.perf_model import V5E
    from repro_torch.dist.sharding import Rules
    cfg, rcfg = get_config("qwen3_8b"), _ref_config("qwen3_8b")
    mesh = SimpleNamespace(shape={"data": 2, "model": 4})
    for shape in ("train_4k", "decode_32k"):
        got = analysis.kernelized_attention_bytes(cfg, SHAPES[shape], 8,
                                                  hw=V5E)
        assert got == pytest.approx(ref(rcfg, rc.SHAPES[shape], 8))
    log, want_log = {}, {}
    got = analysis.kernelized_attention_bytes(
        cfg, SHAPES["train_4k"], 8, mesh=mesh,
        rules=Rules(data=("data",), model="model", tp="model", seq="model"),
        regime_log=log, hw=V5E)
    want = ref(rcfg, rc.SHAPES["train_4k"], 8, mesh=mesh,
               rules=RefRules(data=("data",), model="model", tp="model",
                              seq="model"), regime_log=want_log)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-6)
    assert log == want_log


def test_planner_chain_report_matches_reference():
    from repro.launch.hlo_analysis import planner_chain_report as ref
    from repro import configs as rc
    from repro_torch.core.perf_model import V5E
    cfg = get_config("qwen3_8b", smoke=True)
    from repro.configs import get_config as ref_config
    rcfg = ref_config("qwen3_8b", smoke=True)
    small = {"train_4k": ShapeCell("train_4k", "train", 64, 2),
             "decode_32k": ShapeCell("decode_32k", "decode", 128, 2)}
    for name, shape in small.items():
        got = analysis.planner_chain_report(cfg, shape, hw=V5E)
        want = ref(rcfg, rc.ShapeCell(name, shape.kind, shape.seq,
                                      shape.batch))
        assert got == want, name
    assert analysis.planner_chain_report(
        get_config("mamba2-1.3b"), SHAPES["train_4k"]) == {
            "plannable": False}


# ---------------------------------------------------------------------------
# run_cell and the CLI
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "n_devices", "regime", "memory",
            "collectives", "attention", "planner", "roofline"}


@pytest.mark.parametrize("shape", [ShapeCell("train_4k", "train", 32, 4),
                                   ShapeCell("prefill_32k", "prefill", 32, 4),
                                   ShapeCell("decode_32k", "decode", 32, 4)],
                         ids=lambda s: s.kind)
def test_run_cell_on_a_dry_2x2_mesh(shape):
    from repro_torch.dist.collectives import DryMesh
    rec = dryrun.run_cell("qwen3-8b", shape.name, False,
                          mesh=DryMesh({"data": 2, "model": 2}), smoke=True,
                          shape=shape)
    assert REF_KEYS <= set(rec) and "trace_s" in rec
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_per_device_gb"}
    assert set(rec["roofline"]) >= {
        "flops_per_device", "bytes_per_device", "bytes_per_device_xla",
        "collective_traffic", "compute_s", "memory_s", "memory_s_xla",
        "collective_s", "dominant", "model_flops_per_device",
        "useful_ratio"}
    assert set(rec["attention"]) == {"interior_bytes_xla",
                                     "kernelized_bytes", "n_instances",
                                     "regimes"}
    assert set(rec["collectives"]) == {"counts", "result_bytes",
                                       "traffic_bytes"}
    assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
    assert rec["regime"] == ("tp" if shape.kind == "decode" else "tp+sp")
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["compute_s"] > 0
    assert rec["collectives"]["counts"], rec["collectives"]
    assert rec["memory"]["temp_bytes"] > 0
    json.dumps(rec)


def test_cli_records_a_hybrid_cell_error_and_a_skip(tmp_path, capsys):
    """A hybrid cell records its roofline (recurrentgemma-2b's RG-LRU
    and local attention under the mesh); ``zero3``'s multi-pod form —
    sequence parallelism without tensor parallelism, once refused and
    recorded as an error — runs and records its roofline; a cell the
    skip rule leaves out records its skip."""
    dryrun.main(["--arch", "recurrentgemma-2b", "--shape", "train_4k",
                 "--mesh", "single", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "recurrentgemma_2b__train_4k__single.json"
                      ).read_text())
    assert "error" not in rec and rec["regime"] == "tp+sp"
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["roofline"]["flops_per_device"] > 0
    out = tmp_path / "zero3"
    dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--mesh",
                 "multi", "--regime", "zero3", "--out", str(out)])
    rec = json.loads((out / "qwen3_8b__train_4k__multi.json").read_text())
    assert "error" not in rec and rec["regime"] == "zero3"
    assert rec["mesh"] == "2x16x16" and rec["n_devices"] == 512
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["collectives"]["counts"], rec["collectives"]
    dryrun.main(["--arch", "qwen3-8b", "--shape", "long_500k",
                 "--mesh", "multi", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3_8b__long_500k__multi.json"
                      ).read_text())
    assert "skipped" in rec
    out = capsys.readouterr().out
    assert "[FAIL]" not in out and "[skip]" in out
