"""Serving entry point: batched prefill + greedy decode over a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-8b --batch 4 --prompt-len 64 --gen 32

Two batching modes, as in the JAX package:

* **fixed** (default) — ``generate``: one batch of equal-length prompts,
  prefilled into a contiguous KV cache, then every row decodes in
  lock-step.  On the card the decode step is captured once in a CUDA
  graph and replayed for each token (the counterpart of
  ``jax.jit(model.decode_step)``); the prefill runs eagerly.
* **continuous** (``--continuous``) — the Orca-style
  ``serving.engine.ServingEngine`` over a paged KV cache admits,
  prefills, decodes and evicts requests per iteration on a ragged
  workload; on the card its decode step is captured in a CUDA graph
  too.

The model (``launch.steps.build_model``: an ``LM``, or an ``EncDec`` for
an encoder-decoder config) runs with ``Runtime(kernel_ops=True)``: every
paged decode step's attention goes through the tuned CUDA kernel on the
card (the contiguous cache reaches no kernel, as in the JAX package);
``--device cpu`` is the only way to the plain path, and there every
step runs eagerly.  Weights are random from ``--seed`` (``--full`` for
the published widths, else SMOKE).

Sharded serving: ``--shard-model N`` spawns N ranks itself (a world of
one process per rank, ``launch.mesh.spawn``; gloo, every rank on the
one card or on the CPU) over a 1 x N ("data", "model") mesh, serves
with the decode regime's rules (``sharded_runtime``: resident
tensor-parallel weights, each rank making only its blocks), prints the
tuner's regime choice (spatial or ring for fixed batching,
paged-spatial or paged-ring for ``--continuous``), and prints rank 0's
results.  Under a mesh every decode step runs eagerly (a gloo
collective cannot be captured in a CUDA graph).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..configs import ALIASES, ARCHS, get_config
from ..dist.sharding import Rules
from ..models.lm import Runtime
from .steps import build_model


def generate(model, params, prompts: torch.Tensor, gen: int, *,
             eager: bool = False, prefix_embeds=None, frames=None
             ) -> tuple[np.ndarray, torch.Tensor]:
    """Greedy generation of ``gen`` tokens for each row of ``prompts``
    (B, P), on the model's device, after ``prefix_embeds`` (B, E, D) if
    given (a vision config's patch embeddings), or over ``frames`` (B,
    E, D) (an encoder-decoder's).

    The prefix and the prompts are prefilled eagerly into a fresh
    contiguous cache of E + P + gen positions, and decoding starts at
    position E + P, as in the JAX package — for an encoder-decoder too,
    whose prompts sit at positions 0..P-1, so that its first decoded
    token reads the learned position P + n_frames (ROADMAP Queue 3).
    On a CUDA device the
    decode step is then captured in a CUDA graph
    (``kernels.capture.CapturedStep``) whose eager warm-up is the first
    decode step; every later token is a replay.  The step reads its
    token and position from device tensors and writes the next ones
    back there — and every KV cache and recurrent state in place — so
    nothing returns to the host until the end.  ``eager=True``, a run on
    the CPU and a run under a mesh run each step op by op.

    Returns (tokens (B, gen) int64, the logits (B, V) that chose the
    last token)."""
    b, plen = prompts.shape
    embeds = frames if frames is not None else prefix_embeds
    side = {"frames" if frames is not None else "prefix_embeds": embeds}
    start = plen + (embeds.shape[1] if embeds is not None else 0)
    cache = model.init_cache(b, start + gen)
    logits, cache = model.prefill(params, prompts, cache, **side)
    tok = torch.argmax(logits, dim=-1)
    pos = torch.full((), start, dtype=torch.int32, device=tok.device)
    outs = [tok.clone()]

    def step() -> torch.Tensor:
        logits, _ = model.decode_step(params, cache, tok, pos)
        tok.copy_(torch.argmax(logits, dim=-1))
        pos.add_(1)
        return logits

    if gen > 1 and tok.is_cuda and not eager and model.rt.mesh is None:
        from ..kernels.capture import CapturedStep
        captured = CapturedStep(step, tok.device)
        logits = captured.warmup_out
        outs.append(tok.clone())
        for _ in range(gen - 2):
            logits = captured.replay()
            outs.append(tok.clone())
        logits = logits.clone()     # the graph's buffer dies with it
    else:
        for _ in range(gen - 1):
            logits = step()
            outs.append(tok.clone())
    return torch.stack(outs, dim=1).cpu().numpy(), logits


def demo_side_inputs(cfg, batch: int, device, seed: int) -> dict:
    """``generate``'s side inputs for a config that needs them, standard
    normal draws from ``seed`` in the model's type: stand-in frame
    embeddings ``frames`` (batch, n_frames, d_model) for an
    encoder-decoder config, patch embeddings ``prefix_embeds`` (batch,
    n_prefix_embeds, d_model) for a vision config; none otherwise."""
    if cfg.family == "encdec":
        name, rows = "frames", cfg.encoder.n_frames
    elif cfg.n_prefix_embeds:
        name, rows = "prefix_embeds", cfg.n_prefix_embeds
    else:
        return {}
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: torch.randn((batch, rows, cfg.d_model), generator=gen,
                              device=device).to(getattr(torch, cfg.dtype))}


def sharded_runtime(shard_model: int, mesh=None):
    """(mesh, rules, Runtime) for ``--shard-model N`` serving, inside an
    initialised world: N == 1 is the one-card runtime; N > 1 the host
    mesh with model dim N and the decode regime — resident
    tensor-parallel weights (``fsdp=False``), distributed decode over a
    sequence-sharded cache."""
    if shard_model <= 1:
        return None, None, Runtime(kernel_ops=True)
    from .mesh import make_host_mesh
    mesh = mesh if mesh is not None else make_host_mesh(shard_model)
    rules = Rules(data=("data",), model="model", tp="model", fsdp=False)
    return mesh, rules, Runtime(kernel_ops=True, rules=rules, mesh=mesh,
                                dist_decode_attn=True)


def run_generate(model, params, prompts: torch.Tensor, gen: int, *,
                 mesh=None, rules=None, verbose: bool = True,
                 **side) -> tuple[np.ndarray, float]:
    """``generate`` timed on the host clock, to the tokens on the host;
    ``side``: ``demo_side_inputs``.  With a mesh it first reports the
    tuner's attention regimes for this job (``report_attention_regimes``;
    ``params`` are this rank's shards).  Returns (tokens, seconds)."""
    if mesh is not None:
        cfg = model.cfg
        extra = sum(t.shape[1] for t in side.values() if t is not None)
        report_attention_regimes(
            cfg, mesh, rules, batch=prompts.shape[0],
            prompt_len=prompts.shape[1],
            total_len=prompts.shape[1] + extra + gen, verbose=verbose)
    t0 = time.perf_counter()
    tokens, _ = generate(model, params, prompts, gen, **side)
    return tokens, time.perf_counter() - t0


def report_attention_regimes(cfg, mesh, rules, *, batch: int,
                             prompt_len: int, total_len: int,
                             verbose: bool = True) -> dict:
    """The regime the tuner picks for this serving job's attention
    shapes — prefill (q = kv = prompt) and the grown decode context (q
    = prompt rows over the whole kv) — by the decision
    ``kernels.ops.attention`` dispatches; printed where ``verbose``,
    returned as {label: regime}."""
    from ..kernels import ops

    picks: dict[str, str] = {}
    for label, (m, n) in (("prefill", (prompt_len, prompt_len)),
                          ("decode_ctx", (prompt_len, total_len))):
        choice, _ = ops.attention_regime_choice(
            rules, mesh, batch=batch, q_heads=cfg.n_heads,
            kv_heads=cfg.n_kv_heads, q_len=m, kv_len=n, head_dim=cfg.dh,
            dtype=cfg.dtype, causal=True)
        if choice is None:
            picks[label] = "spatial"
            text = "spatial (mesh offers no kv split)"
        else:
            picks[label] = choice.regime
            text = choice.regime + " (" + " ".join(
                f"{k}={v * 1e6:.1f}us" for k, v in choice.times.items()) + ")"
        if verbose:
            print(f"regime[{label}] q={m} kv={n}: {text}")
    return picks


def ragged_workload(vocab: int, n_requests: int, prompt_len: int,
                    gen: int, seed: int = 0) -> list[tuple[np.ndarray, int]]:
    """Deterministic ragged serving workload: prompt lengths uniform in
    [prompt_len//2, prompt_len], generation budgets in [1, gen] — the
    divergence continuous batching exists to absorb."""
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n_requests):
        plen = int(rng.randint(max(1, prompt_len // 2), prompt_len + 1))
        g = int(rng.randint(1, gen + 1))
        reqs.append((rng.randint(0, vocab, size=plen).astype(np.int32), g))
    return reqs


def make_engine(model, params, *, batch: int, prompt_len: int, gen: int,
                page_size: int, verbose: bool = True,
                eager_decode: bool = False):
    """A ``ServingEngine`` sized for ``batch`` concurrent requests of
    up to ``prompt_len + gen`` positions, with ~25% page slack so
    admission (prompt pages + one decode page of headroom) stays
    fluid without making preemption unreachable.  ``eager_decode``: as
    ``ServingEngine``'s."""
    from ..serving import ServingEngine

    max_pages = math.ceil((prompt_len + gen) / page_size)
    n_pages = 1 + batch * (max_pages + 1) + max(1, batch * max_pages // 4)
    return ServingEngine(model, params, max_batch=batch,
                         page_size=page_size, n_pages=n_pages,
                         max_pages_per_seq=max_pages, verbose=verbose,
                         eager_decode=eager_decode)


def run_continuous(cfg, model, params, *, batch: int, n_requests: int,
                   prompt_len: int, gen: int, page_size: int,
                   seed: int = 0, verbose: bool = True,
                   eager_decode: bool = False):
    """Continuous-batching serving of a ragged workload; returns
    (results, stats, engine).  An encoder-decoder config or one with
    prefix embeddings is refused, as in the JAX package (a hybrid's or
    a state-space config's refusal comes from its paged cache).  Under
    a mesh (the model's ``Runtime``) the engine's regime search picks
    paged-spatial or a ring regime."""
    if cfg.family == "encdec" or cfg.n_prefix_embeds:
        raise NotImplementedError(
            f"--continuous covers decoder-only attention archs without "
            f"side inputs; {cfg.name} needs encoder frames / prefix "
            f"embeddings — serve it fixed-batch")
    reqs = ragged_workload(cfg.vocab, n_requests, prompt_len, gen, seed)
    engine = make_engine(model, params, batch=batch,
                         prompt_len=prompt_len, gen=gen,
                         page_size=page_size, verbose=verbose,
                         eager_decode=eager_decode)
    results, stats = engine.run(reqs)
    return results, stats, engine


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=sorted(ALIASES) + ARCHS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a paged KV cache "
                         "(serving.engine) on a ragged workload")
    ap.add_argument("--requests", type=int, default=0,
                    help="ragged-workload size (default 4x batch)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel path) or cpu (the plain path)")
    ap.add_argument("--shard-model", type=int, default=1,
                    help="ranks of the model dim; > 1 spawns that many "
                         "ranks and serves sharded")
    return ap.parse_args(argv)


def _serve(args, rank: int = 0):
    """One rank's serving run of the parsed ``args``; rank 0 prints."""
    say = rank == 0
    cfg = get_config(args.arch, smoke=not args.full)
    mesh, rules, rt = sharded_runtime(args.shard_model)
    model = build_model(cfg, rt, device=args.device)
    params = model.init_params(args.seed)
    shard = (f" mesh=data1xmodel{args.shard_model}" if mesh is not None
             else "")
    if not args.continuous:
        gen = torch.Generator().manual_seed(args.seed + 1)
        prompts = torch.randint(0, cfg.vocab,
                                (args.batch, args.prompt_len),
                                generator=gen).to(model.device)
        tokens, dt = run_generate(
            model, params, prompts, args.gen, mesh=mesh, rules=rules,
            verbose=say,
            **demo_side_inputs(cfg, args.batch, model.device, args.seed + 2))
        if say:
            print(f"arch={cfg.name} generated {tokens.shape} in {dt:.2f}s "
                  f"({args.batch * args.gen / dt:.1f} tok/s) "
                  f"device={args.device}{shard}")
            print("sample:", tokens[0][:16].tolist())
        return tokens
    results, stats, _ = run_continuous(
        cfg, model, params, batch=args.batch,
        n_requests=args.requests or 4 * args.batch,
        prompt_len=args.prompt_len, gen=args.gen, page_size=args.page_size,
        seed=args.seed + 1, verbose=say)
    counts = [len(r.tokens) for r in results]
    if say:
        print(f"arch={cfg.name} continuous: {len(results)} requests, "
              f"{stats['generated']} tokens in {stats['wall_s']:.2f}s "
              f"({stats['tok_per_s']:.1f} tok/s) "
              f"regime={stats['regime']} steps={stats['decode_steps']} "
              f"preempt={stats['preemptions']} device={args.device}{shard}")
        print(f"per-request generated: {counts}")
        print(phase_line(stats))
    return results


def phase_line(stats: dict) -> str:
    """The engine's phase counters (``serving.engine.PHASES``) as means
    per decode step, and the mean queue wait per admission, in ms."""
    from ..serving.engine import PHASES
    steps, admits = stats["decode_steps"], stats["prefills"]
    means = " ".join(
        f"{k[:-2]}={stats[k] / steps * 1e3:.3f}" if steps else f"{k[:-2]}=-"
        for k in PHASES.values())
    wait = (f"{stats['queue_wait_s'] / admits * 1e3:.3f}" if admits
            else "-")
    return (f"phases, ms per decode step: {means}; queue wait, ms per "
            f"admission: {wait}")


def _serve_rank(rank: int, argv):
    return _serve(_parse(argv), rank)


def main(argv=None):
    args = _parse(argv)
    if args.shard_model <= 1:
        return _serve(args)
    from .mesh import spawn
    return spawn(_serve_rank, args.shard_model, argv, device=args.device)[0]


if __name__ == "__main__":
    main()
