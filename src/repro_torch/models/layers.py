"""Decoder layers as plain functions on tensors: norms, RoPE,
cache-free GQA attention (the forward), GQA attention over a contiguous
KV cache (fixed-batch generation) or a paged one (the serving engine),
the MLP, the mixture of experts (``moe_block``: routing and expert
products in torch ops, as the JAX package's are outside any kernel),
the RG-LRU recurrent block of the hybrid family (``rglru_block`` with
its ``causal_conv1d`` and parallel ``linear_scan``, torch ops as well),
the Mamba-2 block of the state-space family (``mamba_block``: the
chunked SSD in f32 torch ops, ``_ssd_chunked``), the encoder-decoder's
cross-attention (``cross_attention_block``), and the planner-driven
block (``run_planned_layer``).

Parameters are dicts of tensors with the JAX package's names and
layouts (``wq`` is (d_model, n_heads * dh), and so on), so weights carry
across unchanged (``models.convert``).

Cache-free attention has three bodies with one semantics: the fused
CUDA kernel (``kernels.attention.fused_attention`` through
``kernels.ops.attention``) under ``kernel_ops`` for a sequence longer
than one token, and otherwise the model's own twins,
``streaming_attention`` (online softmax over kv blocks) and
``naive_attention`` (the whole score matrix).

Attention over a contiguous cache (``init_attn_cache``) has the JAX
package's two twins, ``streaming_attention`` with the cache's slot
positions for a long prefill and ``_positional_attention`` otherwise;
no kernel runs there, as none does in the JAX package.  Nor does one
run in the recurrent blocks or the cross-attention.

Paged attention has two bodies with one semantics: the fused CUDA
kernel (``kernels.attention.fused_attention_paged``) for decode steps on
the card under ``kernel_ops``, and the gather twin — page-table gather
plus per-request positional attention in torch ops — everywhere else
(prefill, and any run on the CPU), and wherever the circuit breaker
holds the kernel's fingerprint quarantined or its dispatch fails.

Under a mesh (``Mesh``, every family) a block runs on this rank's
shards, Megatron-style: ``wq``/``wk``/``wv`` and the MLP's
``w_gate``/``w_up`` hold this rank's columns over the tensor-parallel
dim, ``wo``/``w_down`` its rows, and the row-parallel products are
summed over the dim (an all-reduce: the JAX package's ``constrain`` to
whole features).  Under autograd the block's input enters the
rank-specific columns through ``Axis.enter`` (its gradient summed over
the dim), the sums go through ``Axis.reduce`` and the gathered kv heads
through ``Axis.gather`` (``dist.collectives``).  ``moe_block`` runs the
JAX package's three mesh layouts: ``local`` (no tensor-parallel dim:
every expert gathered whole, each rank routing its own tokens), ``ep``
(the model dim divides the experts: this rank's experts, the partial
outputs summed) and ``tp`` (every expert on this rank's ffn slice,
summed).  Each rank attends with its q heads; kv heads the dim
cannot divide are gathered whole (``_project_qkv``) and each rank uses
the ones its q heads read (``_kv_for_q``).  A contiguous cache is
heads-sharded where the kv heads divide, else sequence-sharded, and a
sequence-sharded decode step runs ``distributed_decode_attention`` —
or gathers the cache — as the JAX package's.  A paged cache is
heads-sharded, or whole on every rank for the ring regimes
(``dist.ring_dispatch.paged_ring_decode_attention``).  The
``specs_*`` functions give each block's weight layouts
(``dist.sharding``).

The recurrent and cross-attention blocks follow the JAX package's
layouts.  ``rglru_block`` holds this rank's block of the RG-LRU's
channels: the main branch is gathered whole over the dim for the
conv (whose state is whole) and the dense gate products, and the
scan, its state and ``w_out``'s rows are the rank's.  ``mamba_block``
holds this rank's heads: the in-projection's output is gathered whole
(its contiguous column block is not head-aligned), the conv runs on
every channel, B and C stay whole, and the gated norm's sum of squares
is summed over the dim.  ``cross_attention_block`` projects this
rank's q and kv heads; its cache is whole over the dim.  A mixer whose
heads the dim does not divide (recurrentgemma's 10 or whisper's 12 over
16; ``_split_heads``) runs every head on every rank on its weights
gathered whole (``_whole_weights``), its output whole, not summed.

Under sequence parallelism (``Mesh.seq``, Megatron-SP over the
tensor-parallel dim) the residual stream between blocks is this rank's
block of the sequence: a block gathers its normed input over the
sequence (``Axis.gather``, where tensor parallelism alone enters it)
and reduce-scatters its row-parallel output over it (``Axis.scatter``,
where tensor parallelism alone all-reduces it) — ``_enter`` and
``_leave``.

``streaming_attention`` runs inside ``attention_interior``, the region
``launch.op_cost`` attributes to the attention interior.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.planner import act_name, gated
from ..kernels.gemm_chain import act_fn
from ..serving import kv_pages as KP
from .config import ModelConfig

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Mesh:
    """What a block needs of the mesh it runs under: the tensor-parallel
    dim (``dist.collectives.Axis``, None when its size is 1), the mesh
    and rules (for the kernel dispatch's regime search), the call's
    global batch, and the distributed-decode switches of the
    ``Runtime``."""

    mesh: object
    rules: object
    tp: Optional[object]
    batch: int
    dist_decode: bool = False
    dist_pipelined: bool = False
    seq: Optional[object] = None   # the sequence-parallel Axis (the tp
    # one), where the call's sequence divides over it


def _tp(ctx: Optional[Mesh]):
    return ctx.tp if ctx is not None else None


def _seq(ctx: Optional[Mesh]):
    return ctx.seq if ctx is not None else None


def _enter(ctx: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """A block's normed input (B, S, D) made whole for its
    rank-specific columns: gathered over the sequence under sequence
    parallelism (the gradient reduce-scattered), entered under tensor
    parallelism (the gradient all-reduced)."""
    if _seq(ctx) is not None:
        return ctx.seq.gather(x, 1)
    return ctx.tp.enter(x) if _tp(ctx) is not None else x


def _leave(ctx: Optional[Mesh], out: torch.Tensor) -> torch.Tensor:
    """A row-parallel output's partial sums (B, S, D) summed over the
    tensor-parallel dim: reduce-scattered over the sequence under
    sequence parallelism, all-reduced otherwise."""
    if _seq(ctx) is not None:
        return ctx.seq.scatter(out, 1)
    return ctx.tp.reduce(out) if _tp(ctx) is not None else out


def _split_heads(cfg: ModelConfig, tp, heads: Optional[int] = None) -> bool:
    """Whether the tensor-parallel dim ``tp`` splits a mixer's heads
    (``cfg.n_heads`` attention heads, or ``heads``): it divides them,
    and, for attention, each rank's q heads read one run of whole GQA
    groups (``_kv_range``).  Otherwise the mixer runs whole on every
    rank (the JAX package's GSPMD pads such a dim instead)."""
    if tp is None:
        return False
    n = cfg.n_heads if heads is None else heads
    if n % tp.size:
        return False
    if heads is not None:
        return True
    group = cfg.n_heads // cfg.n_kv_heads
    hq = n // tp.size
    return hq % group == 0 or group % hq == 0


def _whole_weights(ctx: Mesh, p: dict, specs: dict) -> dict:
    """A mixer's weights made whole on every rank, for a mixer that runs
    every head (``_split_heads`` False): each weight sharded over the
    tensor-parallel dim gathered along that dim — its gradient this
    rank's block of a gradient every rank holds whole under tensor
    parallelism alone (``"own"``), summed under sequence parallelism,
    where each rank's covers its block of the sequence (``"sum"``) —
    and a replicated one entered under sequence parallelism."""
    tp, sp, name = ctx.tp, _seq(ctx), ctx.rules.tp
    out = {}
    for k, w in p.items():
        dims = [d for d, e in enumerate(specs[k])
                if e == name or (isinstance(e, tuple) and name in e)]
        if dims:
            out[k] = tp.gather(w, dims[0], "sum" if sp is not None
                               else "own")
        else:
            out[k] = sp.enter(w) if sp is not None else w
    return out


def _enter_whole(ctx: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """``_enter`` for a mixer that runs whole on every rank: the
    sequence gathered under sequence parallelism; under tensor
    parallelism alone x as it is (every rank's gradient of it is
    whole)."""
    return ctx.seq.gather(x, 1) if _seq(ctx) is not None else x


def _leave_whole(ctx: Optional[Mesh], out: torch.Tensor) -> torch.Tensor:
    """``_leave`` for a whole mixer's output, whole on every rank: this
    rank's block of the sequence under sequence parallelism."""
    return ctx.seq.shard(out, 1) if _seq(ctx) is not None else out


_INTERIOR = contextvars.ContextVar("attention_interior", default=False)


@contextlib.contextmanager
def attention_interior():
    """The region of the attention interior (score tiles, softmax, P V:
    the work a fused attention kernel keeps on chip), entered by the
    streaming twin; ``launch.op_cost`` attributes the ops run inside
    it."""
    token = _INTERIOR.set(True)
    try:
        yield
    finally:
        _INTERIOR.reset(token)


def in_attention_interior() -> bool:
    return _INTERIOR.get()


def _kv_for_q(kv: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """``kv`` (B, H, N, D), holding this rank's kv heads or all of them,
    repeated to this rank's q heads: each q head beside the kv head it
    reads.  Without a tensor-parallel dim: every head, GQA-repeated."""
    group = cfg.n_heads // cfg.n_kv_heads
    if tp is None or kv.shape[1] != cfg.n_kv_heads:
        return kv.repeat_interleave(group, dim=1)
    lo, hi, g = _kv_range(cfg, tp)
    return kv[:, lo:hi].repeat_interleave(g, dim=1)


def _gather_heads(tp, *ts) -> list:
    """Each of ``ts`` (B, S, heads of this rank, dh), in one type,
    gathered whole along its heads over the tensor-parallel dim in one
    all-gather."""
    sizes = [t.shape[2] for t in ts]
    g = tp.all_gather(torch.cat(ts, dim=2), 2)
    g = g.reshape(*g.shape[:2], tp.size, sum(sizes), g.shape[-1])
    return [t.reshape(*g.shape[:2], -1, g.shape[-1])
            for t in torch.split(g, sizes, dim=3)]


def _kv_range(cfg: ModelConfig, tp) -> tuple[int, int, int]:
    """(first kv head, end, q heads per kv head) that this rank's q
    heads read, of all ``cfg.n_kv_heads``: one run of kv heads, each
    serving a whole group of the rank's q heads."""
    group = cfg.n_heads // cfg.n_kv_heads
    hq = cfg.n_heads // tp.size
    if hq % group and group % hq:
        raise NotImplementedError(
            f"{hq} q heads a rank split GQA groups of {group}")
    lo = tp.index * hq // group
    hi = ((tp.index + 1) * hq - 1) // group + 1
    return lo, hi, hq // (hi - lo)


def specs_norm(cfg: ModelConfig, rules) -> dict:
    """Norm weights are whole on every rank."""
    if cfg.norm == "layernorm":
        return {"w": (), "b": ()}
    return {"w": ()}


def specs_attention(cfg: ModelConfig, rules) -> dict:
    s = {"wq": rules.spec("data", "model"),
         "wk": rules.spec("data", "model"),
         "wv": rules.spec("data", "model"),
         "wo": rules.spec("model", "data")}
    if cfg.qk_norm:
        s["q_norm"] = ()
        s["k_norm"] = ()
    return s


def specs_mlp(cfg: ModelConfig, rules) -> dict:
    if gated(cfg):
        return {"w_gate": rules.spec("data", "model"),
                "w_up": rules.spec("data", "model"),
                "w_down": rules.spec("model", "data")}
    return {"w_up": rules.spec("data", "model"),
            "w_down": rules.spec("model", "data")}


def specs_moe(cfg: ModelConfig, rules, n_model: int) -> dict:
    """Experts sharded over the model dim of ``n_model`` ranks when it
    divides them (expert parallelism), else their ffn dim (the JAX
    package's layouts, ``moe_block``'s ``ep`` and ``tp`` modes)."""
    if rules.enabled and cfg.moe.n_experts % n_model == 0:
        w = w2 = rules.spec("model", None, None)
    else:
        w = rules.spec(None, "data", "model")
        w2 = rules.spec(None, "model", "data")
    s = {"router": (), "w_up": w, "w_down": w2}
    if cfg.act in ("swiglu", "geglu"):
        s["w_gate"] = w
    return s


def specs_mamba(cfg: ModelConfig, rules) -> dict:
    return {"w_in": rules.spec("data", "model"), "conv_w": (),
            "A_log": (), "D": (), "dt_bias": (), "norm_w": (),
            "w_out": rules.spec("model", "data")}


def specs_cross_attention(cfg: ModelConfig, rules) -> dict:
    return specs_attention(cfg, rules)


def specs_rglru(cfg: ModelConfig, rules) -> dict:
    return {"w_gate_br": rules.spec("data", "model"),
            "w_main": rules.spec("data", "model"), "conv_w": (),
            "w_a": rules.spec("data", "model"),
            "w_i": rules.spec("data", "model"), "lam": (),
            "w_out": rules.spec("model", "data")}


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def _rmsnorm_f32(x: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """rmsnorm without the trailing downcast."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + w.float())


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return _rmsnorm_f32(x, w, eps).to(x.dtype)


def _layernorm_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """layernorm without the trailing downcast (the biased variance)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (xf - mu) * torch.rsqrt(var + eps) * w + b


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    return _layernorm_f32(x, w, b, eps).to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``cfg.norm``: layernorm with ``p["w"]`` and ``p["b"]``, or rmsnorm
    with the scale ``1 + p["w"]``."""
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def init_norm(cfg: ModelConfig, device) -> dict:
    """A norm's f32 parameters: layernorm's ``w`` (ones) and ``b``
    (zeros), or rmsnorm's ``w`` (zeros: the scale is 1 + w)."""
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": torch.ones(d, device=device),
                "b": torch.zeros(d, device=device)}
    return {"w": torch.zeros(d, device=device)}


def _rope_f32(x: torch.Tensor, positions: torch.Tensor,
              theta: float) -> torch.Tensor:
    """rope without the trailing downcast.  x: (B, S, H, Dh),
    positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs      # (B, S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    return _rope_f32(x, positions, theta).to(x.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device) -> dict:
    dt = getattr(torch, cfg.dtype)
    d, dh = cfg.d_model, cfg.dh
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * dh), dt, device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * dh), dt, device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * dh), dt, device),
        "wo": dense_init(gen, (cfg.n_heads * dh, d), dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(dh, device=device)
        p["k_norm"] = torch.zeros(dh, device=device)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = getattr(torch, cfg.dtype)
    d, ff = cfg.d_model, cfg.d_ff
    if gated(cfg):
        return {"w_gate": dense_init(gen, (d, ff), dt, device),
                "w_up": dense_init(gen, (d, ff), dt, device),
                "w_down": dense_init(gen, (ff, d), dt, device)}
    return {"w_up": dense_init(gen, (d, ff), dt, device),
            "w_down": dense_init(gen, (ff, d), dt, device)}


def mlp_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[Mesh] = None) -> torch.Tensor:
    """SwiGLU (silu(x Wg) * (x Wu)) Wd, GeGLU with gelu, or the ungated
    gelu(x Wu) Wd, as ``cfg.act`` says (gelu in the tanh form, as the
    JAX package's).  Under a tensor-parallel dim the weights are this
    rank's ffn columns and rows, and the partial products are summed
    over the dim."""
    f = act_fn(act_name(cfg))
    x = _enter(ctx, x)
    if gated(cfg):
        out = (f(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    else:
        out = f(x @ p["w_up"]) @ p["w_down"]
    return _leave(ctx, out)


# ---------------------------------------------------------------------------
# Mixture of experts: one device, or the JAX package's three mesh layouts
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The router (D, E) in f32, and each expert's MLP stacked on a
    leading E axis in the model's type."""
    dt = getattr(torch, cfg.dtype)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"router": dense_init(gen, (d, e), torch.float32, device),
         "w_up": dense_init(gen, (e, d, ff), dt, device),
         "w_down": dense_init(gen, (e, ff, d), dt, device)}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, (e, d, ff), dt, device)
    return p


def route(p: dict, x2d: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Token-choice routing of x2d (T, D): f32 router logits and
    softmax, the top-k experts of each token — among equal
    probabilities the lower index first, as ``jax.lax.top_k`` (a stable
    descending sort) — and their weights renormalised.  Returns (topw
    (T, K) f32, topi (T, K) int64)."""
    probs = torch.softmax(x2d.float() @ p["router"], dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    topw, topi = topw[:, :k], topi[:, :k]
    return topw / topw.sum(dim=-1, keepdim=True), topi


def _combine(yflat: torch.Tensor, dest: torch.Tensor, order: torch.Tensor,
             t: int, k: int) -> torch.Tensor:
    """The weighted expert rows back onto their tokens, in f32.  yflat:
    (slots, D) f32; dest: each expert-sorted assignment's slot (``slots``
    where it was dropped); order: the sort's permutation of the (T*K)
    token-major assignments.  Each token sums its kept rows in
    ascending expert order, starting from zero: the order of the JAX
    package's scatter-add over the expert-sorted slots, and one that
    needs no atomics, so two launches add alike."""
    slots, d = yflat.shape
    yext = torch.cat([yflat, yflat.new_zeros(1, d)])     # dropped: 0
    dest_tk = torch.empty_like(dest).scatter_(0, order, dest)
    dest_tk = dest_tk.reshape(t, k).sort(dim=1).values  # expert order
    out = yflat.new_zeros(t, d)
    for j in range(k):
        out = out + yext.index_select(0, dest_tk[:, j])
    return out


def moe_local(p: dict, x2d: torch.Tensor, cfg: ModelConfig,
              expert_slice: Optional[tuple] = None,
              cap_slice: Optional[tuple] = None,
              scan_threshold: int = 1 << 27) -> torch.Tensor:
    """Token-choice top-k routing on a token block, the JAX package's
    ``_moe_local``.

    x2d: (T, D).  Every expert takes at most ``cap`` assignments in
    token order; the rest are dropped.  expert_slice: (start, count) of
    the experts ``p`` holds (their weights only); None = all.
    cap_slice: (offset, size) window of each expert's capacity handled
    here.  Returns the *partial* f32 output (T, D) of those experts and
    slots.  The capacity is a host integer of the static T, and every
    buffer has a fixed shape, so the step captures in a CUDA graph.

    Each local expert runs its gated MLP over its ``cap`` slots, unused
    slots reading token 0 with weight 0: all E experts at once (batched
    products) while the (E, cap, D) dispatch buffer stays within
    ``scan_threshold`` elements, else one expert at a time.
    """
    moe = cfg.moe
    t, d = x2d.shape
    e, k = moe.n_experts, moe.top_k
    dev = x2d.device
    topw, topi = route(p, x2d, cfg)
    flat_e = topi.reshape(-1)
    flat_t = torch.arange(t * k, device=dev) // k
    se, order = torch.sort(flat_e, stable=True)
    st, sw = flat_t[order], topw.reshape(-1)[order]
    first = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(t * k, device=dev) - first[se]     # slot in expert

    cap = max(8, int(math.ceil(k * t * moe.capacity_factor / e / 8)) * 8)
    e0, e_loc = expert_slice if expert_slice is not None else (0, e)
    c0, cap_loc = cap_slice if cap_slice is not None else (0, cap)
    slots = e_loc * cap_loc
    local = ((se >= e0) & (se < e0 + e_loc) & (pos >= c0)
             & (pos < c0 + cap_loc))
    dest = torch.where(local, (se - e0) * cap_loc + (pos - c0), slots)
    slot_tok = torch.zeros(slots + 1, dtype=st.dtype, device=dev
                           ).scatter(0, dest, st)[:-1]
    slot_w = torch.zeros(slots + 1, device=dev).scatter(0, dest, sw)[:-1]

    f = act_fn(act_name(cfg))
    is_gated = gated(cfg)
    if slots * d <= scan_threshold:
        xe = x2d.index_select(0, slot_tok).reshape(e_loc, cap_loc, d)
        if is_gated:
            h = f(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
        else:
            h = f(torch.bmm(xe, p["w_up"]))
        ye = torch.bmm(h, p["w_down"]).reshape(slots, d)
    else:
        ys = []
        for i in range(e_loc):
            xe = x2d.index_select(0, slot_tok[i * cap_loc:(i + 1) * cap_loc])
            if is_gated:
                h = f(xe @ p["w_gate"][i]) * (xe @ p["w_up"][i])
            else:
                h = f(xe @ p["w_up"][i])
            ys.append(h @ p["w_down"][i])
        ye = torch.cat(ys)
    yflat = ye * slot_w[:, None].to(ye.dtype)
    return _combine(yflat.float(), dest, order, t, k)


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[Mesh] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): every token of the block routed
    together.  One device, or a mesh without a tensor-parallel dim (the
    JAX package's ``local`` mode: ``p`` holds every expert, gathered
    whole, and each rank routes its own tokens): ``moe_local`` alone.
    Under a tensor-parallel dim every rank routes the same tokens and
    the partial outputs, cast to x's type, are summed over the dim:
    ``ep`` where the dim divides the experts (``p`` holds this rank's
    run of them, ``specs_moe``), else ``tp`` (every expert on this
    rank's ffn slice).  The router and the tokens enter through
    ``Axis.enter``: each rank's gradient of them is its experts' or
    its slice's part.  Under sequence parallelism the tokens are
    gathered over the sequence first and the summed output is
    reduce-scattered over it (``_enter``, ``_leave``)."""
    tp = _tp(ctx)
    if tp is None:
        b, s, d = x.shape
        return moe_local(p, x.reshape(b * s, d), cfg).to(
            x.dtype).reshape(b, s, d)
    x = _enter(ctx, x)
    b, s, d = x.shape
    p = dict(p, router=tp.enter(p["router"]))
    x2d = x.reshape(b * s, d)
    e = cfg.moe.n_experts
    if e % tp.size == 0:
        e_loc = e // tp.size
        out = moe_local(p, x2d, cfg, expert_slice=(tp.index * e_loc, e_loc))
    else:
        out = moe_local(p, x2d, cfg)
    return _leave(ctx, out.to(x.dtype).reshape(b, s, d))


def feed_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 ctx: Optional[Mesh] = None) -> torch.Tensor:
    """The block's feed-forward: the experts of an MoE config, the MLP
    otherwise."""
    return (moe_block(p, x, cfg, ctx) if cfg.moe
            else mlp_block(p, x, cfg, ctx))


# ---------------------------------------------------------------------------
# The RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
# torch ops, as the JAX package's are outside any kernel
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv with a silu, accumulated in f32.  x: (B, S,
    C), w: (K, C); state: (B, K-1, C), the inputs before x (zeros when
    None).  Returns (y in x's type, the new state: the trailing K-1
    inputs)."""
    b, s, c = x.shape
    k = w.shape[0]
    if state is None:
        state = x.new_zeros(b, k - 1, c)
    xin = torch.cat([state.to(x.dtype), x], dim=1)      # (B, K-1+S, C)
    y = torch.zeros(b, s, c, dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xin[:, i:i + s].float() * w[i].float()
    return F.silu(y).to(x.dtype), xin[:, s:]


def init_rglru(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The recurrent block's weights: the gate branch, the main branch
    with its conv (f32), the recurrence and input gates, ``lam`` (f32,
    a = sigmoid(lam)^(c r)) and the output projection."""
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_model
    w = int(cfg.rglru.width_mult * d)
    return {
        "w_gate_br": dense_init(gen, (d, w), dt, device),
        "w_main": dense_init(gen, (d, w), dt, device),
        "conv_w": dense_init(gen, (cfg.rglru.conv_kernel, w), torch.float32,
                             device, scale=0.5),
        "w_a": dense_init(gen, (w, w), dt, device),
        "w_i": dense_init(gen, (w, w), dt, device),
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=device),
        "w_out": dense_init(gen, (w, d), dt, device),
    }


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis
    1: log2(S) Hillis-Steele steps of the pair composition
    (a1, b1) then (a2, b2) = (a2 a1, a2 b1 + b2), out of place, so that
    autograd runs through it.  Returns (the cumulative products of a,
    h)."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def _gather_channels(tp, t: torch.Tensor) -> torch.Tensor:
    """This rank's channel block of ``t`` (..., C / n) gathered whole
    along its last dim for consumers that differ by rank: the backward
    reduce-scatters the gradient (``Axis.gather``'s ``"sum"``)."""
    return tp.gather(t, -1)


def rglru_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None,
                ctx: Optional[Mesh] = None) -> torch.Tensor:
    """The Griffin recurrent block: a gelu gate branch times (causal
    conv -> RG-LRU).  x: (B, S, D) -> (B, S, D).  The gates, a and beta
    are f32.  Cache-free (``state`` None) or over a state dict ``{"conv"
    (B, K-1, w), "lru" (B, w) f32}``, which is written IN PLACE, so that
    a captured decode step reads and writes the same tensors.  More than
    one token is a parallel scan (``linear_scan``) with the state folded
    in; one token with a state is a·h + b.

    Under a tensor-parallel dim (``specs_rglru``) ``w_gate_br``,
    ``w_main``, ``w_a`` and ``w_i`` hold this rank's columns and
    ``w_out`` its rows: the main branch is gathered whole over the dim
    (``_gather_channels``) for the conv, whose state is whole, and for
    the dense gate products; the recurrence runs on the rank's channel
    block, as ``lru`` holds it, and ``w_out``'s products are summed
    (``_leave``).  ``conv_w`` and ``lam`` (sliced to the rank's block)
    are replicated and enter the rank's use of them."""
    g = cfg.rglru
    tp = _tp(ctx)
    x = _enter(ctx, x)
    s = x.shape[1]
    conv_w, lam = p["conv_w"], p["lam"]
    gate = act_fn("gelu")(x @ p["w_gate_br"])
    main = x @ p["w_main"]
    if tp is not None:
        main = _gather_channels(tp, main)
        conv_w, lam = tp.enter(conv_w), tp.shard(tp.enter(lam), 0)
    main, new_conv = causal_conv1d(
        main, conv_w, state["conv"] if state is not None else None)
    r = torch.sigmoid((main @ p["w_a"]).float())
    i = torch.sigmoid((main @ p["w_i"]).float())
    log_a = g.c_exponent * r * F.logsigmoid(lam)        # (B, S, w) < 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    if tp is not None:
        main = tp.shard(main, -1)
    bt = beta * i * main.float()
    if state is None or s > 1:
        a_sc, h = linear_scan(a, bt)
        if state is not None:
            h = h + a_sc * state["lru"][:, None]
        h_last = h[:, -1]
    else:
        h_last = a[:, 0] * state["lru"] + bt[:, 0]
        h = h_last[:, None]
    if state is not None:
        state["conv"].copy_(new_conv)
        state["lru"].copy_(h_last)
    y = (gate.float() * h).to(x.dtype)
    return _leave(ctx, y @ p["w_out"])


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, state-space duality, arXiv:2405.21060): torch ops in f32,
# as the JAX package's are outside any kernel
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The Mamba-2 block's weights: the input projection to (z, x, B, C,
    dt), the conv over (x, B, C), ``A_log``, ``D``, ``dt_bias`` and the
    gated norm's ``norm_w`` (all f32), and the output projection."""
    dt = getattr(torch, cfg.dtype)
    s = cfg.ssm
    d = cfg.d_model
    din = s.expand * d
    h = din // s.head_dim
    n = s.n_groups * s.d_state
    return {
        "w_in": dense_init(gen, (d, 2 * din + 2 * n + h), dt, device),
        "conv_w": dense_init(gen, (s.conv_kernel, din + 2 * n),
                             torch.float32, device, scale=0.5),
        "A_log": torch.zeros(h, device=device),     # A = -exp(A_log) = -1
        "D": torch.ones(h, device=device),
        "dt_bias": torch.zeros(h, device=device),
        "norm_w": torch.zeros(din, device=device),
        "w_out": dense_init(gen, (din, d), dt, device),
    }


def ssd_step(h: torch.Tensor, xh: torch.Tensor, da: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor) -> tuple:
    """One step of the SSD recurrence h_t = exp(dA_t) h_{t-1} + B_t x_t,
    y_t = C_t h_t.  h: (b, H, N, P); xh: (b, H, P) scaled by dt; da:
    (b, H); b, c: (b, N).  Returns (y (b, H, P), the new h)."""
    h = h * torch.exp(da)[:, :, None, None] + b[:, None, :, None] \
        * xh[:, :, None, :]
    return (c[:, None, None, :] @ h)[:, :, 0], h


def _ssd_inter(cc: torch.Tensor, prev: torch.Tensor,
               cums: torch.Tensor) -> torch.Tensor:
    """The inter-chunk term: each row's read of the state its chunk
    starts from, decayed to the row.  cc: (b, nc, q, N); prev: (b, nc, H,
    N, P); cums: (b, nc, q, H).  Returns (b, nc, q, H, P)."""
    y = (cc[:, :, None] @ prev).permute(0, 1, 3, 2, 4)     # (b,nc,q,H,P)
    return y * torch.exp(cums)[..., None]


def _ssd_chunked(xh: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int) -> tuple:
    """The SSD in chunked matrix form, the JAX package's ``_ssd_chunked``
    in f32: within a chunk the (l, s) decay matrix, across chunks the
    boundary states carried by a loop over the chunks.  xh: (b, s, H,
    P) scaled by dt; da: (b, s, H) = dt A (<= 0); b, c: (b, s, N) (one
    group); s a multiple of ``chunk``.  Returns (y (b, s, H, P), the
    final state (b, H, N, P)).

    The decay is laid out (b, nc, H, l, s), 4 B x b x s x chunk x H:
    537 MB at b=2, s=4096, chunk 256 and H=64.  Its upper triangle is
    masked before the exp, where the JAX package exponentiates and then
    selects: the same values, and no exp(seg) past f32's range for the
    backward to multiply by a zero cotangent."""
    bs, s, nh, pd = xh.shape
    nc, q = s // chunk, chunk
    xc = xh.reshape(bs, nc, q, nh, pd)
    bc = b.reshape(bs, nc, q, -1)
    cc = c.reshape(bs, nc, q, -1)
    cums = torch.cumsum(da.reshape(bs, nc, q, nh), dim=2)   # (b,nc,q,H)
    total = cums[:, :, -1]                                   # (b,nc,H)

    # intra-chunk (diagonal blocks): cb[l, s] decay[l, s] x[s], summed
    # over s in two steps (the product, then a batched matmul)
    cb = cc @ bc.transpose(-1, -2)                           # (b,nc,l,s)
    ch = cums.transpose(2, 3)                                # (b,nc,H,q)
    seg = ch[..., :, None] - ch[..., None, :]                # (b,nc,H,l,s)
    causal = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, -math.inf))
    xt = xc.permute(0, 1, 3, 2, 4)                           # (b,nc,H,s,P)
    y_intra = ((cb[:, :, None] * decay) @ xt).permute(0, 1, 3, 2, 4)

    # chunk boundary states: S_c = sum_s B_s x_s exp(total - cum_s)
    dec_out = torch.exp(total[:, :, None, :] - cums)         # (b,nc,q,H)
    xd = (xc * dec_out[..., None]).permute(0, 1, 3, 2, 4)    # (b,nc,H,s,P)
    states = bc.transpose(-1, -2)[:, :, None] @ xd           # (b,nc,H,N,P)

    # inter-chunk recurrence over the nc chunks, in order
    h = xh.new_zeros(bs, nh, bc.shape[-1], pd)
    prev = []
    for i in range(nc):
        prev.append(h)                  # the state before chunk i
        h = h * torch.exp(total[:, i])[:, :, None, None] + states[:, i]
    y = y_intra + _ssd_inter(cc, torch.stack(prev, dim=1), cums)
    return y.reshape(bs, s, nh, pd), h


def _sum_squares(tp, ss: torch.Tensor) -> torch.Tensor:
    """This rank's sums of squares summed over the tensor-parallel dim,
    forward and backward (each rank's gradient of the sum is its own
    heads' part): ``Axis.reduce`` then ``Axis.enter``."""
    return tp.enter(tp.reduce(ss))


def _gated_rmsnorm(y: torch.Tensor, w: torch.Tensor, eps: float,
                   tp, width: int) -> torch.Tensor:
    """``rmsnorm`` of y over all ``width`` channels, y holding this
    rank's block of them: the mean square is the sum of squares over
    the dim (``_sum_squares``) over ``width``."""
    yf = y.float()
    ss = _sum_squares(tp, (yf * yf).sum(dim=-1, keepdim=True))
    return (yf * torch.rsqrt(ss / width + eps) * (1.0 + w.float())).to(
        y.dtype)


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None,
                ctx: Optional[Mesh] = None) -> torch.Tensor:
    """The Mamba-2 block: in-projection, causal conv over (x, B, C),
    softplus dt, A = -exp(A_log), the SSD, the D skip, the gated
    rmsnorm and the out-projection.  x: (B, S, D) -> (B, S, D).

    Cache-free (``state`` None) or over a state dict ``{"conv" (B, K-1,
    din + 2N), "ssm" (B, H, N, P) f32}`` written IN PLACE, so that a
    captured decode step reads and writes the same tensors.  More than
    one token runs the chunked SSD from a zero state (a prefill into a
    fresh cache, as in the JAX package), zero-padded to a chunk multiple
    (the padded steps carry dA = 0 and x = 0, so the final state is
    unchanged); one token with a state is ``ssd_step``.

    Under a tensor-parallel dim that divides the heads (``specs_mamba``)
    ``w_in`` holds this rank's columns of [z | x | B | C | dt], a block
    that is not head-aligned, so its output is gathered whole over the
    dim (``_gather_channels``); the conv runs on every channel (its
    state is whole), B and C stay whole, and the SSD, the ``ssm`` state,
    the D skip and the gated norm run on this rank's heads, the norm's
    sum of squares summed over the dim (``_gated_rmsnorm``); ``w_out``'s
    rows are the rank's and its products summed (``_leave``).
    ``conv_w``, ``A_log``, ``D``, ``dt_bias`` and ``norm_w`` are
    replicated and enter the rank's use of them.  Heads the dim does
    not divide run whole on every rank (``_whole_weights``)."""
    sc = cfg.ssm
    din = sc.expand * cfg.d_model
    nh = din // sc.head_dim
    tp = _tp(ctx)
    if tp is not None and not _split_heads(cfg, tp, nh):
        pw = _whole_weights(ctx, p, specs_mamba(cfg, ctx.rules))
        return _leave_whole(ctx, mamba_block(pw, _enter_whole(ctx, x), cfg,
                                             state))
    x = _enter(ctx, x)
    b, s, _ = x.shape
    n = sc.n_groups * sc.d_state
    zxbcdt = x @ p["w_in"]
    conv_w, a_log, d_skip, dt_bias, norm_w = (
        p[k] for k in ("conv_w", "A_log", "D", "dt_bias", "norm_w"))
    if tp is not None:
        zxbcdt = _gather_channels(tp, zxbcdt)
        conv_w = tp.enter(conv_w)
        a_log, d_skip, dt_bias, norm_w = (
            tp.shard(tp.enter(t), 0) for t in (a_log, d_skip, dt_bias,
                                               norm_w))
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * n, nh], dim=-1)
    xbc, new_conv = causal_conv1d(
        xbc, conv_w, state["conv"] if state is not None else None)
    xb, bm, cm = torch.split(xbc, [din, n, n], dim=-1)
    if tp is not None:
        z, xb, dt = (tp.shard(t, -1) for t in (z, xb, dt))
        nh //= tp.size
    dtv = F.softplus(dt.float() + dt_bias)                  # (B,S,H)
    xr = xb.reshape(b, s, nh, sc.head_dim).float()
    xh = xr * dtv[..., None]
    da = dtv * -torch.exp(a_log)
    bm, cm = bm.float(), cm.float()
    if state is None or s > 1:
        pad = (-s) % sc.chunk
        y, h_last = _ssd_chunked(F.pad(xh, (0, 0, 0, 0, 0, pad)),
                                 F.pad(da, (0, 0, 0, pad)),
                                 F.pad(bm, (0, 0, 0, pad)),
                                 F.pad(cm, (0, 0, 0, pad)), sc.chunk)
        y = y[:, :s]
    else:
        y, h_last = ssd_step(state["ssm"], xh[:, 0], da[:, 0], bm[:, 0],
                             cm[:, 0])
        y = y[:, None]
    if state is not None:
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(h_last)
    y = (y + xr * d_skip[:, None]).reshape(b, s, -1).to(x.dtype)
    if tp is None:
        y = rmsnorm(y, norm_w, cfg.norm_eps)
    else:
        y = _gated_rmsnorm(y, norm_w, cfg.norm_eps, tp, din)
    return _leave(ctx, (y * F.silu(z)) @ p["w_out"])


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, tp=None,
                 entered: bool = False) -> tuple:
    """The start of every attention block: the q/k/v projections of x
    (B, S, D), qk-norm, and rope at ``positions`` ((S,) or (B, S)) where
    ``cfg.use_rope`` (a config with learned positions adds them to its
    embeddings instead).  Returns q (B, S, Hq, dh) and k, v (B, S, Hkv,
    dh).  Under a tensor-parallel dim ``tp`` the projections are this
    rank's columns: q holds its Hq / n heads, k and v its Hkv / n — or,
    where the dim does not divide the kv heads, all of them, gathered
    whole before their norm.  ``entered``: x has already been made whole
    for the rank's columns (``_enter``)."""
    b, s, _ = x.shape
    dh = cfg.dh
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    qn, kn = p.get("q_norm"), p.get("k_norm")
    if tp is not None:
        if not entered:
            x = tp.enter(x)
        if cfg.qk_norm:
            qn, kn = tp.enter(qn), tp.enter(kn)
    k, v = x @ p["wk"], x @ p["wv"]
    if tp is not None:
        if hq % tp.size:
            raise NotImplementedError(
                f"{hq} q heads do not divide over {tp.size} ranks")
        hq //= tp.size
        if hkv % tp.size == 0:
            hkv //= tp.size
        else:           # one gather of both, de-interleaved by rank
            c = k.shape[-1]
            kv = tp.gather(torch.cat([k, v], dim=-1), -1)
            kv = kv.reshape(b, s, tp.size, 2, c)
            k, v = kv[:, :, :, 0].reshape(b, s, -1), kv[:, :, :, 1].reshape(
                b, s, -1)
    q = (x @ p["wq"]).reshape(b, s, hq, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, qn, cfg.norm_eps)
        k = rmsnorm(k, kn, cfg.norm_eps)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int, scale: float,
                        bkv: int, q_offset=0,
                        kv_positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """softmax(Q K^T) V over kv blocks of ``bkv`` with an online softmax,
    never materializing the (M, N) scores.  q: (B, H, M, D), k/v:
    (B, H, N, D) (kv heads already repeated).  q rows sit at positions
    ``q_offset + arange(M)`` (an int or a 0-d tensor); ``kv_positions``
    (N,) holds each kv slot's absolute position (a ring cache's, -1 =
    empty), default ``arange(N)``.  P stays f32 through P V, as in the
    JAX twin."""
    with attention_interior():
        return _streaming(q, k, v, causal=causal, window=window,
                          scale=scale, bkv=bkv, q_offset=q_offset,
                          kv_positions=kv_positions)


def _streaming(q, k, v, *, causal, window, scale, bkv, q_offset,
               kv_positions):
    b, h, m, _ = q.shape
    n = k.shape[2]
    bkv = min(bkv, n)
    while n % bkv:          # a sequence the block does not divide
        bkv -= 1
    qf = q.float() * scale
    rows = (q_offset + torch.arange(m, device=q.device))[:, None]
    m_run = torch.full((b, h, m, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, m, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, m, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for j0 in range(0, n, bkv):
        s = torch.einsum("bhmd,bhnd->bhmn", qf,
                         k[:, :, j0:j0 + bkv].float())
        if kv_positions is None:
            cols = j0 + torch.arange(bkv, device=q.device)[None, :]
            mask = None
        else:
            cols = kv_positions[j0:j0 + bkv][None, :]
            mask = cols >= 0
        if causal or window > 0:
            keep = cols <= rows
            if window > 0:
                keep &= cols > rows - window
            mask = keep if mask is None else mask & keep
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        pexp = torch.exp(s - m_new)
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + pexp.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhmn,bhnv->bhmv", pexp,
                                        v[:, :, j0:j0 + bkv].float())
        m_run = m_new
    l_safe = torch.where(l_run == 0.0, 1.0, l_run)
    return (acc / l_safe).to(q.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int,
                    scale: float) -> torch.Tensor:
    """Unfused: the whole (M, N) score matrix, an f32 softmax, P rounded
    to v's type before P V — the paper's baseline.  Shapes and positions
    as ``streaming_attention``."""
    m, n = q.shape[2], k.shape[2]
    s = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    if causal or window > 0:
        rows = torch.arange(m, device=q.device)[:, None]
        cols = torch.arange(n, device=q.device)[None, :]
        mask = cols <= rows
        if window > 0:
            mask &= cols > rows - window
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhmn,bhnv->bhmv", p.to(v.dtype), v).to(q.dtype)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device, shards: tuple = (1, 1)) -> dict:
    """One layer's contiguous KV cache: ``{"k", "v", "pos"}``, k and v
    (B, Hkv, n, dh) in the config's type, ``pos`` (n,) int32 holding
    each slot's absolute position (-1 = empty), shared by the batch, so
    full and ring (windowed) caches share one code path.  ``n`` is
    ``max_len``, or ``min(max_len, cfg.attn_window)`` with a window: a
    ring.  ``shards`` (kv-head ways, slot ways): a rank's block of a
    heads- or sequence-sharded cache; ``pos`` stays whole."""
    win = cfg.attn_window
    n = min(max_len, win) if win else max_len
    dt = getattr(torch, cfg.dtype)
    if cfg.n_kv_heads % shards[0] or n % shards[1]:
        raise ValueError(f"a cache of {cfg.n_kv_heads} kv heads and {n} "
                         f"slots does not split {shards} ways")
    shape = (batch, cfg.n_kv_heads // shards[0], n // shards[1], cfg.dh)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full((n,), -1, dtype=torch.int32, device=device)}


def _positional_attention(q, k, v, rows_pos, kv_pos, causal: bool,
                          window: int, scale: float) -> torch.Tensor:
    """Attention with explicit per-slot positions (decode over a
    contiguous cache).  q: (B, H, M, D), k/v: (B, H, N, D) (kv heads
    already repeated); rows_pos: (M,) query positions; kv_pos: (N,)
    slot positions, -1 = empty."""
    s = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    cols = kv_pos[None, None, None, :]
    rows = rows_pos[None, None, :, None]
    mask = cols >= 0
    if causal or window > 0:
        mask = mask & (cols <= rows)
        if window > 0:
            mask &= cols > rows - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhmn,bhnv->bhmv", p.to(v.dtype), v).to(q.dtype)


def _cached_attention(q, k, v, cfg: ModelConfig, *, positions, cache: dict,
                      bkv: int, causal: bool,
                      ctx: Optional[Mesh] = None,
                      whole: bool = False) -> torch.Tensor:
    """The contiguous cache's branch of ``attention_block``: this
    call's k/v and positions go into the cache IN PLACE at slots
    ``positions % n`` (a ring when windowed), then q attends over the
    cache by position.  q: (B, Hq, S, dh), k/v: (B, Hkv, S, dh);
    positions: (S,), an int32 tensor (a decode step's may live on the
    card, so that a captured step reads it).

    A sequence-sharded cache (``ctx``, ``init_attn_cache``) holds this
    rank's block of the slots, and ``pos`` whole: the rank writes the
    slots it owns, then a decode step under ``ctx.dist_decode`` runs
    ``distributed_decode_attention``, anything else attends over the
    cache gathered whole.  ``whole``: q holds every head (a mixer the
    dim does not split, ``_split_heads``)."""
    s, win = q.shape[2], cfg.attn_window
    tp = _tp(ctx)
    nl = cache["k"].shape[2]
    nc = cache["pos"].shape[0]
    scale = 1.0 / math.sqrt(cfg.dh)
    if win and s >= win:
        # prefill longer than the ring: only the last ``win`` tokens
        # can ever be attended to again
        ks, vs, ps_ = k[:, :, -win:], v[:, :, -win:], positions[-win:]
    else:
        ks, vs, ps_ = k, v, positions
    idx = (ps_ % nc).long()
    cache["pos"][idx] = ps_.to(torch.int32)
    if nl == nc:
        cache["k"][:, :, idx] = ks.to(cache["k"].dtype)
        cache["v"][:, :, idx] = vs.to(cache["v"].dtype)
    else:                   # sequence-sharded: the slots this rank owns
        _write_owned(cache, ks, vs, idx - tp.index * nl)
        if ctx.dist_decode and s == 1:
            return distributed_decode_attention(
                q, cache, positions, cfg, tp, window=win, scale=scale,
                whole=whole)
    if win and s >= win:
        # fresh long prefill: every row's window lies inside this call's
        # k/v — the ring holds only the tail and would starve early
        # rows, so attend over the un-cached projections
        kk, vv, kv_pos = k, v, positions
    elif nl == nc:
        kk, vv, kv_pos = cache["k"], cache["v"], cache["pos"]
    else:   # the JAX package's gather of a sequence-sharded cache
        kk, vv = tp.all_gather(cache["k"], 2), tp.all_gather(cache["v"], 2)
        kv_pos = cache["pos"]
    heads = None if whole else tp
    kk, vv = _kv_for_q(kk, cfg, heads), _kv_for_q(vv, cfg, heads)
    if cfg.use_fused_attention and kk.shape[2] > 2 * bkv and s > 1:
        return streaming_attention(q, kk, vv, causal=causal, window=win,
                                   scale=scale, bkv=bkv,
                                   q_offset=positions[0],
                                   kv_positions=kv_pos)
    # decode / short: single-block scores are already tiny
    return _positional_attention(q, kk, vv, positions, kv_pos, causal, win,
                                 scale)


def _write_owned(cache: dict, ks: torch.Tensor, vs: torch.Tensor,
                 local: torch.Tensor) -> None:
    """Rows of ``ks``/``vs`` (B, H, S, dh) into the slots of this rank's
    block of a sequence-sharded cache, IN PLACE: row i goes to slot
    ``local[i]`` where it lies in ``[0, nl)``.  Shapes depend on no
    value (no ``nonzero``), so a step traces on the ``meta`` device:
    each row writes its slot clamped into the block, with the value its
    slot's owning row gives it (the highest such row), or the slot's
    own value where no row owns it — the rows that share a slot write
    one value."""
    nl = cache["k"].shape[2]
    own = (local >= 0) & (local < nl)
    slot = local.clamp(0, nl - 1).long()
    rows = torch.arange(local.shape[0], device=local.device)
    writer = torch.full((nl,), -1, dtype=rows.dtype, device=local.device
                        ).scatter_reduce(0, slot, torch.where(own, rows, -1),
                                         "amax")[slot]
    keep = (writer < 0)[:, None]
    src = writer.clamp(min=0)
    for name, t in (("k", ks), ("v", vs)):
        buf = cache[name]
        buf[:, :, slot] = torch.where(keep, buf[:, :, slot],
                                      t[:, :, src].to(buf.dtype))


def distributed_decode_attention(q: torch.Tensor, cache: dict,
                                 positions: torch.Tensor, cfg: ModelConfig,
                                 tp, *, window: int, scale: float,
                                 whole: bool = False) -> torch.Tensor:
    """Decode attention over a SEQUENCE-sharded cache without gathering
    it — the JAX package's flash-decode over the model dim.  Each rank
    takes the partial softmax of every q head (gathered, as the JAX
    package's shard_map takes q whole) over its block of the slots
    (``kernels.ref.partial_attention_ref``: f32 scores, P rounded to
    v's type before P V), the ring's combine sums the partials in f32
    (``dist.ring_dispatch.ring_combine``), and the rank keeps its own
    heads of the result.  The new token was written on the owning rank
    only (``_cached_attention``).  q: (B, Hq_local, 1, dh), or every
    head where ``whole`` (then so is the result); cache: {"k", "v"} (B,
    Hkv, N / n, dh), "pos" (N,) whole; positions: (1,)."""
    from ..dist.ring_dispatch import ring_combine
    from ..kernels.ref import partial_attention_ref
    nl = cache["k"].shape[2]
    kv_pos = cache["pos"][tp.index * nl:(tp.index + 1) * nl]
    o, m, l = partial_attention_ref(q if whole else tp.all_gather(q, 1),
                                    cache["k"], cache["v"], kv_pos,
                                    positions, causal=True, window=window,
                                    scale=scale)
    o = ring_combine(o, m, l, tp, torch.float32, q.dtype, pipelined=False)
    return o if whole else tp.shard(o, 1)


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, bkv: int = 512,
                    kernel_ops: bool = False,
                    cache: Optional[dict] = None,
                    causal: bool = True,
                    ctx: Optional[Mesh] = None) -> torch.Tensor:
    """GQA attention over ``cfg.attn_window``, causal unless ``causal``
    is False (an encoder's).  x: (B, S, D); positions: (S,) absolute
    positions of x's tokens.

    With a contiguous ``cache`` (``init_attn_cache``) this call's k/v
    are written into it IN PLACE and q attends over the cache by
    position (``_cached_attention``), as the JAX package's cache branch
    does; no kernel runs there, as in the JAX package.  Without one it
    is the cache-free forward: ``kernel_ops`` routes a sequence of more
    than one token through ``kernels.ops.attention`` — the tuned CUDA
    kernel, GQA inside the kernel, no head repeat; otherwise the kv
    heads are repeated and the model's twin runs:
    ``streaming_attention`` past two kv blocks
    (``cfg.use_fused_attention``), ``naive_attention`` below.

    Under a mesh (``ctx``) the block runs on this rank's heads, the
    kernel through ``kernels.ops.attention_shard`` (the regime the
    tuner picks for the global shape) on the rank's q heads and the kv
    heads they read, and ``wo``'s partial products are summed over the
    tensor-parallel dim; under sequence parallelism x is this rank's
    block of the sequence, gathered whole first, and the output is its
    block of the sum (``_enter``, ``_leave``).  A sequence-sharded cache
    holds every kv head: this call's are gathered whole before the
    write.  Heads the dim does not split (``_split_heads``) run whole on
    every rank, on the weights gathered whole (``_whole_weights``)."""
    tp = _tp(ctx)
    whole = tp is not None and not _split_heads(cfg, tp)
    if whole:
        p = _whole_weights(ctx, p, specs_attention(cfg, ctx.rules))
        x = _enter_whole(ctx, x)
    elif _seq(ctx) is not None:
        x = _enter(ctx, x)
    b, s, _ = x.shape
    dh = cfg.dh
    win = cfg.attn_window
    q, k, v = _project_qkv(p, x, cfg, positions, None if whole else tp,
                           entered=_seq(ctx) is not None)
    if (cache is not None and tp is not None and not whole
            and cache["k"].shape[1] == cfg.n_kv_heads
            and k.shape[2] != cfg.n_kv_heads):
        k, v = _gather_heads(tp, k, v)  # a sequence-sharded cache
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scale = 1.0 / math.sqrt(dh)
    if cache is not None:
        o = _cached_attention(q, k, v, cfg, positions=positions,
                              cache=cache, bkv=bkv, causal=causal, ctx=ctx,
                              whole=whole)
    elif kernel_ops and s > 1:
        from ..kernels import ops
        if ctx is None or whole:
            o = ops.attention(q, k, v, causal=causal, window=win,
                              scale=scale)
        else:
            # this rank's q heads over the kv heads they read: kv heads
            # gathered whole (the dim does not divide them) are cut to
            # the rank's run, and the tuner sees the ranks' blocks of
            # them side by side
            hkv = cfg.n_kv_heads
            if tp is not None and k.shape[1] == hkv:
                lo, hi, _ = _kv_range(cfg, tp)
                k, v, hkv = k[:, lo:hi], v[:, lo:hi], (hi - lo) * tp.size
            o = ops.attention_shard(
                q, k, v, batch=ctx.batch, q_heads=cfg.n_heads,
                kv_heads=hkv, mesh=ctx.mesh, rules=ctx.rules,
                causal=causal, window=win, scale=scale)
    else:
        heads = None if whole else tp
        kk, vv = _kv_for_q(k, cfg, heads), _kv_for_q(v, cfg, heads)
        if cfg.use_fused_attention and s > 2 * bkv:
            o = streaming_attention(q, kk, vv, causal=causal, window=win,
                                    scale=scale, bkv=bkv)
        else:
            o = naive_attention(q, kk, vv, causal=causal, window=win,
                                scale=scale)
    out = o.transpose(1, 2).reshape(b, s, -1) @ p["wo"]
    return _leave_whole(ctx, out) if whole else _leave(ctx, out)


def cross_attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                          enc_out: Optional[torch.Tensor] = None,
                          kv_cache: Optional[dict] = None,
                          ctx: Optional[Mesh] = None) -> torch.Tensor:
    """The decoder's attention over the encoder output, non-causal and
    unfused (``naive_attention``), as in the JAX package.  x: (B, S, D);
    the keys and values are ``enc_out``'s (B, T, D) projections —
    written into ``kv_cache`` ``{"k", "v"}`` (B, Hkv, T, dh) IN PLACE
    when one is given (a prefill) — or, without ``enc_out``, read from
    ``kv_cache`` (a decode step).

    Under a tensor-parallel dim (``specs_cross_attention``) q comes from
    the decoder's entered input on this rank's heads, k and v from
    ``enc_out`` (which the caller enters) on its kv heads, and ``wo``'s
    products are summed (``_leave``).  The cache is whole over the dim,
    as the JAX package lays it out: a prefill gathers the kv heads whole
    before the write, and each rank reads the ones its q heads use
    (``_kv_for_q``).  Heads the dim does not split run whole on every
    rank (``_whole_weights``)."""
    tp = _tp(ctx)
    if tp is not None and not _split_heads(cfg, tp):
        pw = _whole_weights(ctx, p, specs_cross_attention(cfg, ctx.rules))
        return _leave_whole(ctx, cross_attention_block(
            pw, _enter_whole(ctx, x), cfg, enc_out=enc_out,
            kv_cache=kv_cache))
    x = _enter(ctx, x)
    b, s, _ = x.shape
    dh = cfg.dh
    q = (x @ p["wq"]).reshape(b, s, -1, dh).transpose(1, 2)
    if enc_out is not None:
        t = enc_out.shape[1]
        k, v = ((enc_out @ p[w]).reshape(b, t, -1, dh) for w in ("wk", "wv"))
        if kv_cache is not None:
            if k.shape[2] != kv_cache["k"].shape[1]:
                k, v = _gather_heads(tp, k, v)
            kv_cache["k"].copy_(k.transpose(1, 2))
            kv_cache["v"].copy_(v.transpose(1, 2))
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    else:
        k, v = kv_cache["k"], kv_cache["v"]
    o = naive_attention(q, _kv_for_q(k, cfg, tp), _kv_for_q(v, cfg, tp),
                        causal=False, window=0, scale=1.0 / math.sqrt(dh))
    return _leave(ctx, o.transpose(1, 2).reshape(b, s, -1) @ p["wo"])


def _paged_positional_attention(q, k, v, rows_pos, kv_pos, window: int,
                                scale: float) -> torch.Tensor:
    """Attention with PER-REQUEST position vectors — the paged gather
    twin.  q: (B, H, M, D), k/v: (B, H, N, D) (kv heads already
    repeated); rows_pos: (B, M) global query positions (-1 = masked
    row); kv_pos: (B, N) global position of each gathered slot (-1 =
    unallocated)."""
    s = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    cols = kv_pos[:, None, None, :]
    rows = rows_pos[:, None, :, None]
    mask = (cols >= 0) & (cols <= rows)
    if window > 0:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhmn,bhnv->bhmv", p.to(v.dtype), v).to(q.dtype)


def paged_attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                          positions: torch.Tensor, cache: dict,
                          page_table: torch.Tensor,
                          kernel_ops: bool = False,
                          block: Optional[tuple] = None,
                          ctx: Optional[Mesh] = None
                          ) -> tuple[torch.Tensor, dict]:
    """Attention over a paged KV cache.

    x: (B, S, D); positions: (B, S) absolute position of each row
    (-1 = masked: prompt padding or an inactive engine slot); cache:
    ``{"k_pages", "v_pages"}`` of shape (n_pages, Hkv, page_size, dh)
    — the shared pool, written IN PLACE; page_table: (B, max_pages)
    physical page per logical page (-1 = unallocated).  Serving is
    causal by construction.

    Under a mesh the pools hold this rank's kv heads, or every kv head
    (``LM.init_paged_cache``: the ring regimes, or kv heads the dim does
    not divide) — then this call's k/v are gathered whole before the
    write.  A decode step under ``ctx.dist_decode`` runs the ring
    regime over the page-table columns
    (``dist.ring_dispatch.paged_ring_decode_attention``) on every q
    head and keeps this rank's; anything else runs the paged body on
    this rank's q heads.
    """
    b, s, _ = x.shape
    dh = cfg.dh
    ps = cache["k_pages"].shape[2]
    tp = _tp(ctx)
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    ring = (tp is not None and ctx.dist_decode and s == 1
            and page_table.shape[1] % tp.size == 0)
    whole_kv = cache["k_pages"].shape[1] != k.shape[2]    # pools whole
    if ring:        # every q head, and the kv heads the pools take
        q, *kv = _gather_heads(tp, q, *((k, v) if whole_kv else ()))
        k, v = kv or (k, v)
    elif whole_kv:
        k, v = _gather_heads(tp, k, v)

    phys, off = KP.slot_coords(page_table, positions, ps)
    KP.scatter_pages(cache["k_pages"], phys, off, k)
    KP.scatter_pages(cache["v_pages"], phys, off, v)

    qt = q.transpose(1, 2)
    scale = 1.0 / math.sqrt(dh)
    if ring:
        from ..dist.ring_dispatch import paged_ring_decode_attention
        o = paged_ring_decode_attention(
            qt, cache["k_pages"], cache["v_pages"], page_table,
            positions[:, 0], window=cfg.window, scale=scale, mesh=ctx.mesh,
            axis_name=tp.names[0], pipelined=ctx.dist_pipelined,
            kernel=kernel_ops, block=block)
        o = tp.shard(o, 1)
    else:
        o = _paged_attention_body(qt, cache, page_table, positions,
                                  cfg=cfg, tp=tp, win=cfg.window,
                                  scale=scale, kernel_ops=kernel_ops,
                                  block=block)
    o = o.transpose(1, 2).reshape(b, s, -1)
    out = o @ p["wo"]
    return (tp.all_reduce(out) if tp is not None else out), cache


def _paged_attention_body(qt: torch.Tensor, cache: dict,
                          page_table: torch.Tensor,
                          positions: torch.Tensor, *, cfg: ModelConfig,
                          win: int, scale: float, tp=None,
                          kernel_ops: bool = False,
                          block: Optional[tuple] = None) -> torch.Tensor:
    """The paged attention core: the fused kernel or the gather twin.
    qt: (B, Hq, S, dh) — this rank's q heads under a tensor-parallel
    dim ``tp``, which read the pools' kv heads ``_kv_range`` gives
    where the pools hold every kv head; cache holds the POST-write page
    pools."""
    b, hq, s, _ = qt.shape
    kp, vp = cache["k_pages"], cache["v_pages"]
    ps = kp.shape[2]
    group = hq // kp.shape[1]
    if tp is not None and kp.shape[1] == cfg.n_kv_heads:
        lo, hi, group = _kv_range(cfg, tp)
        kp, vp = kp[:, lo:hi], vp[:, lo:hi]

    def _twin() -> torch.Tensor:
        # page-table gather + per-request positional attention: the
        # body every other path is held to, and the shadow oracle of
        # the fused branch below
        kk = KP.gather_pages(kp, page_table).repeat_interleave(group, dim=1)
        vv = KP.gather_pages(vp, page_table).repeat_interleave(group, dim=1)
        kv_pos = KP.paged_kv_positions(page_table, ps)
        return _paged_positional_attention(qt, kk, vv, positions, kv_pos,
                                           win, scale)

    if kernel_ops and s == 1 and qt.is_cuda:
        # decode only: the kernel's tail convention needs q rows at
        # lengths-M..lengths-1, which padded prefill rows violate.
        # ``block`` carries the tuner's winning tiles, so the executed
        # schedule is the one the model priced.  Dispatch is guarded
        # (``kernels.ops._guarded``): a quarantined or failing kernel
        # degrades to the gather twin, a wrong_answer fault and the
        # sampled shadow check sit on its output, and any failure but
        # an injected fault or a launch the card refused raises.
        from ..kernels.attention import fused_attention_paged
        from ..kernels.ops import _guarded
        bq, bkv = block if block is not None else (128, 128)
        fp = ("attn-paged", b, hq, ps, page_table.shape[1], win, bq, bkv,
              str(qt.dtype).replace("torch.", ""))
        return _guarded(fp, lambda: fused_attention_paged(
            qt, kp, vp, page_table, positions[:, -1] + 1, bq=bq, bkv=bkv,
            window=win, scale=scale), _twin,
            rows=lambda: positions[:, -1] >= 0)
    return _twin()


# ---------------------------------------------------------------------------
# Planner-driven layer execution (core/planner.py)
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted type: a stitched prologue leaves x f32-wide
    while the weights keep the model's type."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def run_planned_layer(lp, p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, rt, cache: dict,
                      page_table: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """Execute one attention block from a planner ``LayerPlan`` — the
    zero-hand-specified-chains path behind ``Runtime(planner=True)``.

    Walks the plan's op DAG; every node runs the same torch code the
    hand-wired block runs (``paged_attention_block`` + ``mlp_block``),
    so a stitch-disabled plan is bit-identical to the hand-wired layer.
    Glue stitched into a carved chain as prologue/epilogue instead
    computes in f32 (the ``_*_f32`` twins) with ONE downcast at the
    carved unit's boundary, where a fused kernel's final store would
    round; on float32 configs that is still bitwise identical.

    Serving plans carry a ``kv_write`` node: this step's k/v are
    scattered IN PLACE into the paged ``cache`` ({"k_pages",
    "v_pages"}) through ``page_table``, then the attention core runs the
    shared ``_paged_attention_body`` (the CUDA decode kernel under
    ``rt.kernel_ops`` on the card, the gather twin otherwise).  Only
    paged caches are executed.

    Kernel dispatch: under ``rt.kernel_ops`` a *fused* planner-carved
    MLP chain runs as ONE ``kernels.ops.mlp_chain`` call (the tuned
    ``fused_mlp_chain`` CUDA kernel on the card, its plain version on
    the CPU); its stitched prologue/epilogue (ln2/res2) still run
    f32-wide around the call, exactly as in the node walk.

    lp: ``core.planner.LayerPlan``; p: the layer's parameters
    ({"ln1", "mix", "ln2", "ff"}).  Returns ``(out, cache)``.
    """
    if cache is None or "k_pages" not in cache or page_table is None:
        raise NotImplementedError(
            "run_planned_layer executes paged serving caches only "
            "(a {'k_pages', 'v_pages'} cache and its page_table)")
    b, s, d = x.shape
    dh = cfg.dh
    dt = x.dtype
    pm, pf = p["mix"], p["ff"]

    stitched: set = set()
    downcast_at: set = set()
    for c in lp.chains:
        stitched.update(c.prologue)
        stitched.update(c.epilogue)
        if c.prologue or c.epilogue:
            # the unit computes wide past its stitched glue; cast back
            # to the model dtype exactly once, where the kernel's final
            # store would round
            downcast_at.add(c.epilogue[-1] if c.epilogue else c.ops[-1])

    # Under kernel_ops, a fused MLP chain executes as ONE tuned kernel
    # call at its first op; the folded ops are skipped in the walk.
    mlp_unit = None
    mlp_folded: set = set()
    if rt.kernel_ops:
        mlp_unit = next((c for c in lp.chains
                         if c.kind == "mlp" and c.fused), None)
        if mlp_unit is not None:
            mlp_folded = set(mlp_unit.ops[1:])

    env: dict = {"x": x}
    for node in lp.nodes:
        nm, role, ins = node.name, node.role, node.ins
        if nm in mlp_folded:
            continue
        if mlp_unit is not None and nm == mlp_unit.ops[0]:
            from ..kernels import ops
            x2d = env[ins[0]].reshape(b * s, d)
            out = ops.mlp_chain(
                x2d, pf["w_up"], pf["w_down"],
                w_gate=pf["w_gate"] if gated(cfg) else None,
                act=act_name(cfg)).reshape(b, s, d)
            nm = mlp_unit.ops[-1]
            if nm in downcast_at:
                out = out.to(dt)
            env[nm] = out
            continue
        if role == "norm":
            # DAG node names ln1/ln2 mirror the parameter keys
            out = (_rmsnorm_f32(env[ins[0]], p[nm]["w"], cfg.norm_eps)
                   if nm in stitched
                   else rmsnorm(env[ins[0]], p[nm]["w"], cfg.norm_eps))
        elif role == "gemm":
            xin = env[ins[0]]
            if nm in ("wq", "wk", "wv"):
                heads = cfg.n_heads if nm == "wq" else cfg.n_kv_heads
                out = _mm(xin, pm[nm]).reshape(b, s, heads, dh)
            elif nm == "wo":
                out = _mm(xin, pm["wo"])
            elif nm in ("w_gate", "w_up", "w_down"):
                out = _mm(xin, pf[nm])
            else:
                raise ValueError(f"unknown gemm node {nm!r}")
        elif role == "qk_norm":
            w = pm["q_norm"] if nm.endswith("_q") else pm["k_norm"]
            out = (_rmsnorm_f32(env[ins[0]], w, cfg.norm_eps)
                   if nm in stitched
                   else rmsnorm(env[ins[0]], w, cfg.norm_eps))
        elif role == "rope":
            out = (_rope_f32(env[ins[0]], positions, cfg.rope_theta)
                   if nm in stitched
                   else rope(env[ins[0]], positions, cfg.rope_theta))
        elif role == "kv_write":
            # this step's k/v written through to the pool, as the
            # hand-wired block does (masked rows land on the scratch
            # page); the attention core then reads the cache
            kp, vp = cache["k_pages"], cache["v_pages"]
            phys, off = KP.slot_coords(page_table, positions, kp.shape[2])
            KP.scatter_pages(kp, phys, off, env[ins[0]].to(kp.dtype))
            KP.scatter_pages(vp, phys, off, env[ins[1]].to(vp.dtype))
            out = None
        elif role == "attn_qk":
            # the attention core executes as one unit (fused chain or
            # not — fusion changes pricing and kernel dispatch, not the
            # math): the shared paged body, as the hand-wired block
            o = _paged_attention_body(
                env[ins[0]].transpose(1, 2), cache, page_table, positions,
                cfg=cfg, win=cfg.window, scale=1.0 / math.sqrt(dh),
                kernel_ops=rt.kernel_ops, block=rt.paged_block)
            env["qk"] = env["softmax"] = None   # folded into this unit
            out = o.transpose(1, 2).reshape(b, s, cfg.n_heads * dh)
            nm = "pv"
        elif role in ("softmax", "attn_pv"):
            continue                            # handled at attn_qk
        elif role == "gate_act":
            out = act_fn(act_name(cfg))(env[ins[0]])
            if gated(cfg):
                out = out * env[ins[1]]
        elif role == "residual":
            mix, res = env[ins[0]], env[ins[1]]
            out = (res.float() + mix.float() if nm in stitched
                   else res + mix)
        else:
            raise ValueError(f"unknown node role {role!r}")
        if nm in downcast_at:
            out = out.to(dt)
        env[nm] = out

    out = env[lp.nodes[-1].name]
    return out.to(dt), cache
