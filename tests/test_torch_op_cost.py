"""``launch.op_cost.OpCost``, the port's counterpart of the JAX
package's ``launch/hlo_cost.py``: the counterparts of
``tests/test_hlo_cost.py``'s five cases (eager loops in place of
scans: each pass is counted as it runs), the same counts on the
``meta`` device as on the CPU for a SMOKE train step in each remat
mode, the attention interior's attribution, the peak against the live
bytes, and the collectives' ring pricing on a dry mesh.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.op_cost import OpCost  # noqa: E402


def _cost_of(fn, *args):
    c = OpCost()
    with c:
        c.hold(*args)
        fn(*args)
    return c


def test_plain_matmul_flops():
    a = torch.empty(256, 512, device="meta")
    b = torch.empty(512, 128, device="meta")
    c = _cost_of(lambda x, y: x @ y, a, b).total
    assert c.flops == c.mm_flops == 2 * 256 * 512 * 128
    assert c.bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)


def test_looped_matmul_flops_multiplied_by_passes():
    steps = 10
    stack = torch.empty(steps, 128, 128, device="meta")

    def fn(stack):
        carry = torch.eye(128, device=stack.device)
        for w in stack:
            carry = torch.tanh(carry @ w)
        return carry

    c = _cost_of(fn, stack).total
    assert c.mm_flops == steps * 2 * 128 ** 3
    # tanh: one flop an element a pass; eye writes its elements
    assert c.flops == c.mm_flops + steps * 128 * 128


def test_nested_loop_flops():
    def fn(stack):
        carry = torch.eye(64, device=stack.device)
        for w in stack:
            for _ in range(4):
                carry = carry @ w
        return carry

    c = _cost_of(fn, torch.empty(5, 64, 64, device="meta")).total
    assert c.mm_flops == 5 * 4 * 2 * 64 ** 3


def test_bytes_scale_with_passes():
    def fn(stack):
        carry = torch.zeros(512, 512, device=stack.device)
        for x in stack:
            carry = carry + torch.tanh(x)
        return carry

    c8 = _cost_of(fn, torch.empty(8, 512, 512, device="meta")).total
    c32 = _cost_of(fn, torch.empty(32, 512, 512, device="meta")).total
    # tanh and add: two flops an element a pass (zeros computes none)
    assert c32.flops / c8.flops == pytest.approx(4.0)
    assert c32.bytes > 3.5 * c8.bytes


def test_slice_writes_not_overcounted():
    """Writing a small slice into a big buffer each pass costs ~slice
    bytes, not ~buffer bytes: an index write and a copy into a view."""
    n, steps = 4096, 16

    def fn(xs):
        buf = torch.zeros(n, n, device=xs.device)
        for i in range(steps):
            buf[i] = xs[i]                                     # copy_
            buf.index_put_((torch.tensor([i + steps], device=xs.device),),
                           xs[i][None])
        return buf

    c = _cost_of(fn, torch.empty(steps, n, device="meta")).total
    full = steps * n * n * 4
    zeros = n * n * 4                   # the buffer written once
    assert c.bytes - zeros < full * 0.01, (c.bytes, full)


def test_peak_follows_live_storages():
    def fn(x):
        a = x * 2                          # 4 MB live
        b = a.view(-1) + 1                 # 4 MB more; a's view not new
        del a
        c = b * 3                          # a freed: 8 MB again
        return c

    x = torch.empty(1024, 1024, device="meta")
    c = OpCost()
    with c:
        assert c.hold(x) == 4 << 20
        out = fn(x)
        assert c.live == 4 << 20           # only the output is alive
    assert c.peak == 3 * (4 << 20)
    del out
    assert c.live == 0


def _smoke_step(dev, remat, policy):
    """(OpCost, loss) of one SMOKE qwen3 train step at S = 48, bkv = 16
    (the streaming twin) on ``dev``: seeded weights on the CPU, their
    ``meta`` counterparts (``abstract_params``) on ``meta``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models.lm import LM, Runtime
    cfg = get_config("qwen3-8b", smoke=True)
    model = LM(cfg, Runtime(remat=remat, remat_policy=policy, bkv=16),
               device=dev)
    opt = S.default_optimizer()
    if dev == "meta":
        params = model.abstract_params()
        state = opt.abstract_state(params)
    else:
        params = model.init_params(0)
        state = opt.init(params)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (2, 48), generator=g).to(dev)
             for k in ("tokens", "labels")}
    c = OpCost()
    with c:
        c.hold(params, state, batch)
        _, _, info = S.make_train_step(model, opt)(params, state, batch)
    return c, info["loss"]


@pytest.mark.parametrize("remat,policy", [(False, None), (True, None),
                                          (True, "dots")],
                         ids=["none", "full", "dots"])
def test_meta_counts_equal_cpu_counts(remat, policy):
    got, _ = _smoke_step("meta", remat, policy)
    want, loss = _smoke_step("cpu", remat, policy)
    assert torch.isfinite(loss)
    assert got.n_ops == want.n_ops
    for region in ("attn", "rest"):
        assert dataclasses.asdict(getattr(got, region)) == \
            dataclasses.asdict(getattr(want, region)), region
    assert (got.held, got.peak) == (want.held, want.peak)
    # the interior: the score and P V products (``bmm``) and the softmax
    assert got.attn.mm_flops > 0 and got.attn.flops > got.attn.mm_flops


def test_remat_recomputes_and_lowers_the_peak():
    none, _ = _smoke_step("meta", False, None)
    full, _ = _smoke_step("meta", True, None)
    dots, _ = _smoke_step("meta", True, "dots")
    # dots recomputes the attention's batched products, full every one
    assert full.total.mm_flops > dots.total.mm_flops > none.total.mm_flops
    assert full.peak < none.peak and dots.peak < none.peak
    assert full.peak <= dots.peak


def test_collectives_priced_by_ring_traffic():
    from repro_torch.core.ring import ring_traffic_bytes
    from repro_torch.dist.collectives import DryMesh
    mesh = DryMesh({"data": 2, "model": 4}, rank=5)
    ax = mesh.axis("model")
    assert (ax.size, ax.index, ax.ranks) == (4, 1, (4, 5, 6, 7))
    both = mesh.axis(("data", "model"))
    assert (both.size, both.index) == (8, 5)
    x = torch.empty(8, 16, device="meta")
    c = OpCost()
    with c:
        g = ax.all_gather(x, 0)
        r = ax.reduce_scatter(g, 0)
        s = ax.all_reduce(r)
        ax.shift(s)
    assert tuple(g.shape) == (32, 16) and tuple(r.shape) == (8, 16)
    want = [("all-gather", 32 * 16 * 4, 4), ("reduce-scatter", 8 * 16 * 4, 4),
            ("all-reduce", 8 * 16 * 4, 4),
            ("collective-permute", 8 * 16 * 4, 4)]
    assert c.collectives.records == want
    assert c.collectives.traffic_bytes == sum(
        ring_traffic_bytes(k, b, n) for k, b, n in want)
    assert c.total.flops == 0 and c.n_ops == 0
