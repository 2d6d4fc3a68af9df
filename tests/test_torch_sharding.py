"""The port's logical-axis sharding rules against the JAX package's.

Counterparts of ``tests/test_dist_sharding.py`` (all but its
``PartitionSpec`` indexing contract, which the port's own layout type
does not have), the MeshSpec constructors of the dispatcher and the
tuner bridge against the reference's on the same mesh shapes, and the
model's weight and cache layouts against the reference's
``PartitionSpec``s.  Layouts are compared per dim as the tuple of mesh
dims they name (jax writes a one-name tuple as the name).
"""
import collections

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.sharding import (Rules, batch_placement,  # noqa: E402
                                       constrain, default_rules,
                                       dispatch_mesh_spec, local_shape,
                                       mesh_shape, ring_dispatch_spec)
from repro_torch.launch.mesh import tuner_mesh_spec  # noqa: E402


class FakeMesh:
    """Stands in for a mesh where only its dims' sizes are read."""

    def __init__(self, **axes):
        self.shape = collections.OrderedDict(axes)


RULES = Rules(data=("data",), model="model", tp="model", seq=None)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _same_layout(got, want) -> bool:
    got, want = tuple(got), tuple(want)
    n = max(len(got), len(want))
    pad = (None,) * n
    return ([_names(e) for e in (got + pad)[:n]]
            == [_names(e) for e in (want + pad)[:n]])


# ---------------------------------------------------------------------------
# disabled rules
# ---------------------------------------------------------------------------

def test_disabled_rules_replicate_everything():
    r = Rules.disabled()
    assert not r.enabled
    assert r.spec("data", "model") == (None, None)
    assert r.batch_spec(8, FakeMesh(data=4)) is None
    x = torch.ones(2, 3)
    assert constrain(x, r, FakeMesh(data=4), (8, 3), "batch", None) is x


def test_enabled_flag():
    assert RULES.enabled
    assert Rules(data=("data",)).enabled
    assert Rules(model="model").enabled
    assert not Rules().enabled


# ---------------------------------------------------------------------------
# spec: weight layouts
# ---------------------------------------------------------------------------

def test_spec_maps_logical_names():
    assert RULES.spec("data", "model") == (("data",), "model")
    assert RULES.spec("model", "data") == ("model", ("data",))
    assert RULES.spec(None, "tp") == (None, "model")
    assert RULES.spec(None, None, None) == (None, None, None)


def test_spec_multi_axis_data():
    r = Rules(data=("pod", "data"), model="model", tp="model")
    assert r.spec("data", "model") == (("pod", "data"), "model")


def test_spec_fsdp_off_makes_weights_resident():
    r = Rules(data=("data",), model="model", tp="model", fsdp=False)
    assert r.spec("data", "model") == (None, "model")
    assert r.spec("model", "data") == ("model", None)


def test_spec_rejects_unknown_logical_axis():
    with pytest.raises(ValueError):
        RULES.spec("bogus")


# ---------------------------------------------------------------------------
# batch_spec: graceful degradation, in the port's own type
# ---------------------------------------------------------------------------

def test_batch_spec_divisible():
    assert RULES.batch_spec(4, FakeMesh(data=2, model=4)) == ("data",)


def test_batch_spec_no_mesh():
    assert RULES.batch_spec(4, None) is None


def test_batch_spec_non_divisible_batch_unsharded():
    assert RULES.batch_spec(3, FakeMesh(data=2, model=4)) is None


def test_batch_spec_drops_size_one_axes():
    assert RULES.batch_spec(4, FakeMesh(data=1, model=4)) is None


def test_batch_spec_batch_axes_override_drops_from_right():
    r = Rules(data=("data",), model="model",
              batch_axes=("data", "model"), tp=None)
    assert r.batch_spec(8, FakeMesh(data=2, model=4)) == ("data", "model")
    assert r.batch_spec(2, FakeMesh(data=2, model=4)) == ("data",)
    assert r.batch_spec(1, FakeMesh(data=2, model=4)) is None


def test_batch_placement_is_the_batch_entry_or_nothing():
    mesh = FakeMesh(data=2, model=4)
    assert batch_placement(RULES, mesh, 4) == ("data",)
    assert batch_placement(RULES, mesh, 3) == ()


# ---------------------------------------------------------------------------
# constrain: a layout check on local tensors
# ---------------------------------------------------------------------------

def test_constrain_without_mesh_is_identity():
    x = torch.arange(8.0).reshape(2, 4)
    assert constrain(x, RULES, None, (2, 4), "batch", "tp") is x


def test_constrain_disabled_inside_mesh_is_identity():
    x = torch.arange(8.0).reshape(2, 4)
    assert constrain(x, Rules.disabled(), FakeMesh(data=1), (2, 4),
                     "batch", None) is x


def test_constrain_under_trivial_mesh_preserves_values():
    x = torch.arange(12.0).reshape(2, 6)
    y = constrain(x, RULES, FakeMesh(data=1, model=1), (2, 6), "batch",
                  "tp")
    assert torch.equal(x, y)


def test_constrain_ignores_extra_logical_names():
    x = torch.ones(2, 3)
    assert constrain(x, RULES, FakeMesh(data=2, model=1), (4, 3), "batch",
                     None, None, None) is x


def test_constrain_checks_the_local_shape():
    mesh = FakeMesh(data=2, model=4)
    x = torch.ones(2, 3, 8)                 # (4, 3, 32) over data, model
    assert constrain(x, RULES, mesh, (4, 3, 32), "batch", None, "tp") is x
    with pytest.raises(ValueError, match="local shape"):
        constrain(x, RULES, mesh, (4, 3, 32), "batch", None, None)
    # a dim the mesh cannot divide stays whole, as _dim_axes drops it
    assert constrain(torch.ones(3, 8), RULES, mesh, (3, 32), "batch",
                     "tp").shape == (3, 8)


def test_local_shape_and_mesh_shape():
    mesh = FakeMesh(data=2, model=4)
    assert mesh_shape(mesh) == {"data": 2, "model": 4}
    assert local_shape((8, 12, 5), (("data",), "model"), mesh) == (4, 3, 5)
    with pytest.raises(ValueError):
        local_shape((3, 4), ("data",), mesh)


def test_default_rules():
    r = default_rules(FakeMesh(pod=2, data=4, model=2))
    assert r.data == ("pod", "data") and r.model == r.tp == "model"


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

LOGICAL = [("data", "model"), ("model", "data"), (None, "tp"),
           ("batch", "seq", None), ("model", None, None), (None,)]
RULE_SETS = [
    dict(data=("data",), model="model", tp="model"),
    dict(data=("data",), model="model", tp="model", fsdp=False),
    dict(data=("pod", "data"), model="model", tp=None, seq="model",
         batch_axes=("pod", "data", "model")),
    dict(),
]


@pytest.mark.parametrize("kw", RULE_SETS)
@pytest.mark.parametrize("logical", LOGICAL)
def test_spec_and_batch_spec_match_reference(kw, logical):
    pytest.importorskip("jax")
    from repro.dist.sharding import Rules as RefRules
    got, want = Rules(**kw), RefRules(**kw)
    assert _same_layout(got.spec(*logical), want.spec(*logical))
    for mesh in (FakeMesh(pod=2, data=2, model=4), FakeMesh(data=4),
                 FakeMesh(data=2, model=2)):
        for b in (1, 2, 3, 4, 8, 16):
            ref = want.batch_spec(b, mesh)
            assert _names(got.batch_spec(b, mesh)) == (
                _names(tuple(ref)[0]) if len(ref) else ())


MESHES = [dict(data=2, model=4), dict(data=1, model=4), dict(data=4, model=2),
          dict(data=8, model=1), dict(pod=2, data=2, model=2)]


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_specs_match_reference_canonically(shape):
    """``dispatch_mesh_spec``, ``ring_dispatch_spec`` and
    ``tuner_mesh_spec`` give the reference's ``MeshSpec.canonical()``
    on the same mesh shapes, over batches, features and kv lengths that
    divide and that do not."""
    pytest.importorskip("jax")
    from repro.dist import sharding as RS
    from repro.launch import mesh as RM
    mesh = FakeMesh(**shape)
    for kw in RULE_SETS[:3]:
        got_r, ref_r = Rules(**kw), RS.Rules(**kw)
        for b in (1, 2, 4, 6):
            for kind, feats in (("gemm", (512,)), ("gemm", (6,)),
                                ("attention", (8, 32)),
                                ("attention", (1, 48)),
                                ("attention", (4, 6))):
                g = dispatch_mesh_spec(got_r, mesh, kind=kind, batch=b,
                                       feature_dims=feats)
                w = RS.dispatch_mesh_spec(ref_r, mesh, kind=kind, batch=b,
                                          feature_dims=feats)
                assert g[0].canonical() == w[0].canonical()
                assert g[1:] == w[1:]
                g = tuner_mesh_spec(mesh, got_r, kind=kind, batch=b,
                                    feature_dim=feats[0])
                w = RM.tuner_mesh_spec(mesh, ref_r, kind=kind, batch=b,
                                       feature_dim=feats[0])
                assert g.canonical() == w.canonical()
            for n in (4096, 4098, 160):
                g = ring_dispatch_spec(got_r, mesh, batch=b, kv_len=n)
                w = RS.ring_dispatch_spec(ref_r, mesh, batch=b, kv_len=n)
                assert g[0].canonical() == w[0].canonical()
                assert g[1:] == w[1:]
                g = tuner_mesh_spec(mesh, got_r, kind="attention", batch=b,
                                    reduction_dim=n, shard_reduction=True)
                w = RM.tuner_mesh_spec(mesh, ref_r, kind="attention",
                                       batch=b, reduction_dim=n,
                                       shard_reduction=True)
                assert g.canonical() == w.canonical()
        for kind in ("gemm", "attention"):
            for red in (False, True):
                g = tuner_mesh_spec(mesh, got_r, kind=kind,
                                    shard_reduction=red)
                w = RM.tuner_mesh_spec(mesh, ref_r, kind=kind,
                                       shard_reduction=red)
                assert g.canonical() == w.canonical()


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-20b"])
@pytest.mark.parametrize("shape", [dict(data=2, model=2),
                                   dict(data=1, model=4),
                                   dict(data=2, model=4)])
@pytest.mark.parametrize("fsdp", [True, False])
def test_param_and_cache_specs_match_reference(arch, shape, fsdp):
    """The model's weight layouts (the reference's stacked specs less
    their layer dim) and cache layouts name the same mesh dims per dim
    as the reference's ``PartitionSpec``s: heads-sharded caches for
    qwen3's 2 kv heads where the model dim divides them, else
    sequence-sharded (granite's single kv head)."""
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.dist.sharding import Rules as RefRules
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime

    from repro_torch.models.lm import LM, Runtime
    kw = dict(data=("data",), model="model", tp="model", fsdp=fsdp)
    mesh = FakeMesh(**shape)
    cfg = get_config(arch, smoke=True)
    got = LM(cfg, Runtime(rules=Rules(**kw), mesh=mesh), device="cpu")
    want = RefLM(ref_config(arch, smoke=True),
                 RefRuntime(rules=RefRules(**kw), mesh=mesh))
    gs, ws = got.param_specs(), want.param_specs()
    for name in ("embed", "lm_head"):
        assert _same_layout(gs[name], ws[name]), name
    assert _same_layout(gs["final_norm"]["w"], ws["final_norm"]["w"])
    stack = ws["stack"]["b0_attn"]
    for layer in gs["layers"]:
        for blk, leaves in layer.items():
            for leaf, layout in leaves.items():
                ref = tuple(stack[blk][leaf])[1:]
                assert _same_layout(layout, ref), (blk, leaf)
    for b in (4, 3):
        gc = got.cache_specs(b)
        wc = want.cache_specs(b)["stack"][0]
        for c in gc:
            for leaf in ("k", "v", "pos"):
                assert _same_layout(c[leaf], tuple(wc[leaf])[1:]), leaf
    heads = cfg.n_kv_heads % shape["model"] == 0
    assert (gs["layers"][0]["mix"]["wk"][1] == "model")
    assert (got.cache_specs(4)[0]["k"][1] == "model") == heads


def test_param_specs_cover_every_leaf_and_other_kinds_have_layouts():
    """``param_specs`` mirrors ``init_params`` leaf for leaf, and the
    kinds the mesh does not run yet still state their layouts."""
    from repro_torch import tree as T
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LM, Runtime
    cfg = get_config("qwen3-8b", smoke=True)
    model = LM(cfg, Runtime(rules=RULES, mesh=FakeMesh(data=2, model=2)),
               device="cpu")
    params = LM(cfg, device="cpu").init_params(0)
    specs = model.param_specs()
    assert ([p for p, _ in T.leaves_with_paths(params)]
            == [p for p, _ in T.leaves_with_paths(
                T.map_tree(lambda t, sp: 0, params, specs))])
    for fn, conf in ((L.specs_mamba, "mamba2-1.3b"),
                     (L.specs_rglru, "recurrentgemma-2b")):
        assert fn(get_config(conf, smoke=True), RULES)["w_out"] == (
            "model", ("data",))
    moe = get_config("olmoe-1b-7b", smoke=True)
    assert L.specs_moe(moe, RULES, 2)["w_up"] == ("model", None, None)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b",
                                  "mamba2-1.3b", "whisper-small"])
def test_mesh_refuses_the_other_families(arch):
    """Every family runs under a mesh on the hand-wired path — the MoE,
    hybrid, state-space and encoder-decoder families build their
    sharded layouts — and each one's planner-requested runtime still
    refuses one, naming the queue item that brings it."""
    from repro_torch.launch.steps import build_model
    from repro_torch.models.lm import Runtime
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, Runtime(rules=RULES,
                                     mesh=FakeMesh(data=1, model=2)),
                        device="cpu")
    assert model.param_specs()["embed"] == ("model", ("data",))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        build_model(cfg, Runtime(rules=RULES, mesh=FakeMesh(data=1, model=2),
                                 planner=True), device="cpu")
