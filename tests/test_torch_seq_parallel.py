"""Sequence parallelism (``Rules(seq=...)``, Megatron-SP over the
tensor-parallel dim), axes over several mesh dims, and the collectives
a step records, on gloo worlds of spawned ranks at SMOKE in f32.

* 2 x 2 and 1 x 4 worlds under SP: ``LM.loss`` and its gradients
  (reduced and gathered whole), the cache-free logits and a prefill's
  last logits against one device's (qwen3, granite-20b whose kv head
  the model dim cannot divide, olmoe in the ``ep`` layout, and at 6
  experts in the ``tp`` layout);
* a 2 x 2 x 1 ``("pod", "data", "model")`` world with the batch over
  ``("pod", "data")``: one process group over both dims;
* each rank of the 2 x 2 SP world's train step under ``OpCost``: its
  collectives (kind, result bytes, participants, in order), flops, ops
  and bytes equal to the dry trace of the same rank's step on a
  ``DryMesh`` on the ``meta`` device, its peak within 1 %;
* the refusals: ``rules.seq`` on another dim than tp, the paged path
  under SP, the planned path under a mesh.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402

GRAD_REL_TOL = 1e-4                 # tests/test_torch_train.py
TOL = dict(rtol=3e-4, atol=1e-5)    # f32 sums in other orders
B, S = 4, 16
ARCHS = {"2x2": ("qwen3-8b", "granite-20b", "olmoe-1b-7b"),
         "1x4": ("qwen3-8b", "olmoe-6")}


def _cfg(arch):
    from repro_torch.configs import get_config
    if arch == "olmoe-6":
        cfg = get_config("olmoe-1b-7b", smoke=True)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=6))
    return get_config(arch, smoke=True)


def _batch(vocab):
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, vocab, (B, S))).long()
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return {"tokens": tokens, "labels": labels}


def _sp_rules(pods=False):
    from repro_torch.dist.sharding import Rules
    if pods:
        return Rules(data=("pod", "data"), model="model", tp="model")
    return Rules(data=("data",), model="model", tp="model", seq="model")


def _run(model, params, batch):
    """(loss, gradients reduced, logits, prefill's last logits) of one
    model on whole inputs (this rank's shards of ``params``)."""
    from repro_torch.launch import steps as St
    from repro_torch.models.lm import requires_grad
    params = requires_grad(params)
    loss = model.loss(params, batch)
    loss.backward()
    grads = [p.grad for p in T.leaves(params)]
    if model.rt.mesh is not None:
        St.reduce_gradients(model, grads, T.leaves(model.param_specs(),
                                                   like=params), B)
    with torch.no_grad():
        logits = model.forward(params, batch["tokens"])
        last, _ = model.prefill(params, batch["tokens"],
                                model.init_cache(B, S + 4))
    return float(loss.detach()), grads, logits, last


def _gathered(model, leaves):
    from repro_torch.dist.collectives import gather_dims
    with torch.no_grad():
        return [gather_dims(g, lay, model.rt.mesh).numpy().copy()
                for g, lay in zip(leaves, T.leaves(model.param_specs(),
                                                   like=model._proto))]


# ---------------------------------------------------------------------------
# rank bodies (module level, no jax)
# ---------------------------------------------------------------------------

def _sp_world(rank, layout, whole):
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, Runtime
    mesh = make_host_mesh({"2x2": 2, "1x4": 4}[layout])
    out = {}
    for arch in ARCHS[layout]:
        cfg = _cfg(arch)
        model = LM(cfg, Runtime(rules=_sp_rules(), mesh=mesh), device="cpu")
        model._proto = whole[arch]
        loss, grads, logits, last = _run(
            model, St.shard_params(model, T.map_tree(
                lambda t: t.clone(), whole[arch])), _batch(cfg.vocab))
        out[arch] = (loss, _gathered(model, grads), logits.numpy(),
                     last.numpy())
    if layout == "2x2":
        out["counted"] = _counted_step(whole["qwen3-8b"], mesh)
    return out


def _counted_step(whole, mesh):
    """This rank's train step of qwen3 SMOKE under SP, counted."""
    from repro_torch.launch import steps as St
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.lm import LM, Runtime
    model = LM(_cfg("qwen3-8b"), Runtime(rules=_sp_rules(), mesh=mesh),
               device="cpu")
    params = St.shard_params(model, T.map_tree(lambda t: t.clone(), whole))
    opt = St.default_optimizer()
    state = opt.init(params)
    batch = _batch(model.cfg.vocab)
    c = OpCost()
    with c:
        c.hold(params, state, batch)
        St.make_train_step(model, opt)(params, state, batch)
    return _summary(c)


def _summary(c) -> dict:
    return {"records": c.collectives.records, "flops": c.total.flops,
            "bytes": c.total.bytes, "peak": c.peak, "held": c.held,
            "n_ops": c.n_ops}


def _pod_world(rank, whole):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.dist.collectives import axis
    from repro_torch.launch import steps as St
    from repro_torch.models.lm import LM, Runtime
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1),
                      mesh_dim_names=("pod", "data", "model"))
    ax = axis(mesh, ("pod", "data"))
    assert ax is axis(mesh, ("pod", "data"))        # made once
    model = LM(_cfg("qwen3-8b"), Runtime(rules=_sp_rules(pods=True),
                                         mesh=mesh), device="cpu")
    model._proto = whole
    loss, grads, logits, last = _run(
        model, St.shard_params(model, T.map_tree(lambda t: t.clone(),
                                                 whole)),
        _batch(model.cfg.vocab))
    summed = ax.all_reduce(torch.tensor([float(rank)]))
    return dict(axis=(ax.size, ax.index, ax.ranks), summed=float(summed),
                out=(loss, _gathered(model, grads), logits.numpy(),
                     last.numpy()))


# ---------------------------------------------------------------------------
# fixtures and tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whole():
    """arch -> the seeded whole params, and one device's results."""
    from repro_torch.models.lm import LM, Runtime
    out = {}
    for arch in ("qwen3-8b", "granite-20b", "olmoe-1b-7b", "olmoe-6"):
        model = LM(_cfg(arch), Runtime(), device="cpu")
        params = model.init_params(0)
        loss, grads, logits, last = _run(
            model, T.map_tree(lambda t: t.clone(), params),
            _batch(model.cfg.vocab))
        out[arch] = (params, (loss, [g.numpy() for g in grads],
                              logits.numpy(), last.numpy()))
    return out


@pytest.fixture(scope="module")
def worlds(whole):
    from repro_torch.launch.mesh import spawn
    params = {a: p for a, (p, _) in whole.items()}
    out = {layout: spawn(_sp_world, 4, layout, params)
           for layout in ARCHS}
    out["pods"] = spawn(_pod_world, 4, params["qwen3-8b"])
    return out


def _held(got, want, what):
    loss, grads, logits, last = got
    wloss, wgrads, wlogits, wlast = want
    assert loss == pytest.approx(wloss, rel=1e-5), what
    worst = max(float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
                for g, w in zip(grads, wgrads))
    assert worst <= GRAD_REL_TOL, (what, worst)
    np.testing.assert_allclose(logits, wlogits, **TOL, err_msg=what)
    np.testing.assert_allclose(last, wlast, **TOL, err_msg=what)


@pytest.mark.parametrize("layout,arch", [(lay, a) for lay in ARCHS
                                         for a in ARCHS[lay]])
def test_sequence_parallel_matches_one_device(worlds, whole, layout, arch):
    for rank, out in enumerate(worlds[layout]):
        _held(out[arch], whole[arch][1], f"{layout} {arch} rank {rank}")


def test_batch_over_pod_and_data(worlds, whole):
    ranks = worlds["pods"]
    assert [r["axis"] for r in ranks] == [(4, i, (0, 1, 2, 3))
                                          for i in range(4)]
    assert all(r["summed"] == 6.0 for r in ranks)
    for rank, r in enumerate(ranks):
        _held(r["out"], whole["qwen3-8b"][1], f"pods rank {rank}")


@pytest.mark.parametrize("rank", range(4))
def test_recorded_collectives_equal_the_dry_trace(worlds, whole, rank):
    """The real rank's step and the dry trace of the same rank on a
    ``DryMesh``: the same collectives in the same order and the same
    flops, ops and bytes; the peak within 1 %."""
    from repro_torch.dist.collectives import DryMesh
    from repro_torch.launch import steps as St
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.lm import LM, Runtime
    mesh = DryMesh({"data": 2, "model": 2}, rank=rank)
    model = LM(_cfg("qwen3-8b"), Runtime(rules=_sp_rules(), mesh=mesh),
               device="meta")
    params = St.local_specs(model.abstract_params(), model.param_specs(),
                            mesh)
    opt = St.default_optimizer()
    state = opt.abstract_state(params)
    batch = {k: v.to("meta") for k, v in _batch(model.cfg.vocab).items()}
    c = OpCost()
    with c:
        c.hold(params, state, batch)
        St.make_train_step(model, opt)(params, state, batch)
    got, want = worlds["2x2"][rank]["counted"], _summary(c)
    assert got["records"] == want["records"]
    kinds = {k for k, _, _ in want["records"]}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    assert (got["flops"], got["held"]) == (want["flops"], want["held"])
    # the same ops and bytes: a collective's result reaches autograd as
    # an alias of its own (``dist.collectives._released``), so the
    # engine adopts it as a gradient whatever gloo's worker thread still
    # holds (it copied it, an op the trace lacks, on 8-25 % of the
    # backward's reduce-scatters before); a storage that worker frees
    # late can still lift the peak for a moment
    assert got["n_ops"] == want["n_ops"]
    assert got["bytes"] == want["bytes"]
    assert got["peak"] == pytest.approx(want["peak"], rel=1e-2)


def test_sequence_parallel_refusals():
    from repro_torch.dist.collectives import DryMesh
    from repro_torch.dist.sharding import Rules
    from repro_torch.models.lm import LM, Runtime
    mesh = DryMesh({"data": 2, "model": 2})
    cfg = _cfg("qwen3-8b")
    # sequence parallelism without tensor parallelism (the zero3
    # regime's multi-pod form), paged serving under it and the planned
    # path under a mesh build now; SP over another dim than a
    # tensor-parallel one refuses
    solo = LM(cfg, Runtime(rules=Rules(data=("data",), model="model",
                                       seq="model"), mesh=mesh),
              device="meta")
    assert solo._sp is not None and solo._tp is None
    assert solo._ctx(2, 64).seq.size == 2 and solo._ctx(2, 1).seq is None
    with pytest.raises(NotImplementedError, match="tensor-parallel dim"):
        LM(cfg, Runtime(rules=Rules(data=("data",), model="model",
                                    tp="model", seq="data"), mesh=mesh),
           device="meta")
    model = LM(cfg, Runtime(rules=_sp_rules(), mesh=mesh), device="meta")
    pools = model.init_paged_cache(4, 8)
    assert pools[0]["k_pages"].shape == (4, cfg.n_kv_heads // 2, 8, cfg.dh)
    assert LM(_cfg("recurrentgemma-2b"), Runtime(rules=_sp_rules(),
                                                 mesh=mesh, planner=True),
              device="meta").rt.planner
    assert LM(_cfg("recurrentgemma-2b"), Runtime(rules=_sp_rules(),
                                                 mesh=mesh),
              device="meta").kinds[:3] == ["rglru", "rglru", "attn"]


def test_owned_slot_write_matches_the_row_selection():
    """``layers._write_owned`` (no value-dependent shape) writes what
    selecting the owned rows writes, over a ring that wraps."""
    from repro_torch.models.layers import _write_owned
    g = torch.Generator().manual_seed(0)
    for n_local, lo, idx in [(8, 8, [5, 6, 7, 8, 9, 10]),
                             (8, 0, [14, 15, 0, 1, 2]),
                             (4, 4, [7]), (4, 4, [1])]:
        idx = torch.tensor(idx)
        cache = {k: torch.randn(2, 3, n_local, 4, generator=g)
                 for k in ("k", "v")}
        ks, vs = (torch.randn(2, 3, len(idx), 4, generator=g)
                  for _ in range(2))
        want = {k: t.clone() for k, t in cache.items()}
        own = ((idx >= lo) & (idx < lo + n_local)).nonzero()[:, 0]
        want["k"][:, :, idx[own] - lo] = ks[:, :, own]
        want["v"][:, :, idx[own] - lo] = vs[:, :, own]
        _write_owned(cache, ks, vs, idx - lo)
        for k in cache:
            assert torch.equal(cache[k], want[k]), (lo, idx)


@pytest.mark.parametrize("seq", [None, "model"], ids=["tp", "tp+sp"])
def test_residual_stream_is_sharded_over_the_sequence(monkeypatch, seq):
    """Under SP each block takes this rank's block of the sequence,
    (B / data, S / model, D), and the step moves activations by
    reduce-scatter and all-gather instead of all-reduce; a decode step
    (S = 1) runs plain tensor parallelism."""
    from repro_torch.configs import SHAPES
    from repro_torch.dist.collectives import DryMesh
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LM, Runtime
    mesh = DryMesh({"data": 2, "model": 2})
    cfg = _cfg("qwen3-8b")
    model = LM(cfg, Runtime(rules=Rules(data=("data",), model="model",
                                        tp="model", seq=seq), mesh=mesh),
               device="meta")
    from repro_torch.launch import steps as St
    params = St.local_specs(model.abstract_params(), model.param_specs(),
                            mesh)
    shapes = []
    for name in ("attention_block", "feed_forward"):
        real = getattr(L, name)
        monkeypatch.setattr(L, name, lambda p, x, *a, _r=real, **k: (
            shapes.append(tuple(x.shape)), _r(p, x, *a, **k))[1])
    batch = {k: v.to("meta") for k, v in _batch(cfg.vocab).items()}
    c = OpCost()
    with c, torch.no_grad():
        model.loss(params, batch)
    s_local = S // 2 if seq else S
    assert set(shapes) == {(B // 2, s_local, cfg.d_model)}
    act = B // 2 * S * cfg.d_model * 4          # a rank's whole activation
    recs = c.collectives.records
    if seq:
        assert ("reduce-scatter", act // 2, 2) in recs
        assert ("all-reduce", act, 2) not in recs
    else:
        assert ("all-reduce", act, 2) in recs
    shapes.clear()
    cell = dataclasses.replace(SHAPES["decode_32k"], batch=B, seq=S)
    cache = St.local_specs(St.abstract_cache(model, cfg, cell),
                           model.cache_specs(B), mesh)
    model.decode_step(params, cache, batch["tokens"][:, 0],
                      torch.zeros((), dtype=torch.int32, device="meta"))
    assert set(shapes) == {(B // 2, 1, cfg.d_model)}
