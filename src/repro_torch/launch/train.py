"""The training entry point — the port of the JAX package's
``repro.launch.train`` on one device.

Wires together: configs -> model -> optimizer -> data pipeline ->
fault-tolerant StepRunner (checkpoint/restart).  It runs on the card
unless ``--device cpu`` is passed, and never falls back to the CPU.
The model trains with ``Runtime(kernel_ops=False)``, as the JAX
package's ``launch.train`` does: the cache-free attention twins under
autograd, cuBLAS for the matrix products; no kernel of the port is on
this path.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 6 --batch 2 --seq 64

``train(cfg, ...)`` is ``main``'s body for any ``ModelConfig``
(``chip_smoke.py`` runs it at a depth-cut qwen3-8b); an encoder-decoder
config's batches carry per-step frame embeddings, a vision config's
prefix embeddings.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import tree as T
from ..configs import ALIASES, ARCHS, get_config
from ..data.pipeline import DataConfig, TokenPipeline
from ..models.config import ModelConfig
from ..models.lm import Runtime
from ..optim.adamw import AdamW, cosine_schedule
from ..runtime.fault_tolerance import StepRunner
from . import steps as S


def make_optimizer(lr: float, steps: int) -> AdamW:
    """The CLI's AdamW: cosine schedule with ``min(10, steps // 4 +
    1)`` warmup steps over ``max(steps, 100)``, clip 1.0, decay 0.1."""
    return AdamW(lr=cosine_schedule(lr, warmup=min(10, steps // 4 + 1),
                                    total=max(steps, 100)),
                 clip_norm=1.0)


def side_embeds(cfg: ModelConfig, rows: int, batch: int, seed: int,
                step: int, device) -> torch.Tensor:
    """Step ``step``'s stand-in embeddings (batch, rows, d_model): a
    standard normal draw in the model's type from a generator seeded
    with (seed, step), as the JAX package's ``launch.train`` draws them
    from ``fold_in(PRNGKey(seed), step)`` (the pair mixed into the 32
    bits a CPU generator keeps)."""
    mixed = np.random.SeedSequence((seed, step)).generate_state(1)[0]
    gen = torch.Generator(device=device).manual_seed(int(mixed))
    return torch.randn((batch, rows, cfg.d_model), generator=gen,
                       device=device).to(getattr(torch, cfg.dtype))


def prefix_embeds(cfg: ModelConfig, batch: int, seed: int, step: int,
                  device) -> torch.Tensor:
    """A vision config's patch embeddings of step ``step``."""
    return side_embeds(cfg, cfg.n_prefix_embeds, batch, seed, step, device)


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 4,
          seq: int = 128, lr: float = 3e-4, ckpt_dir: str = "",
          ckpt_every: int = 10, seed: int = 0, log_every: int = 5,
          device="cuda") -> dict:
    """Train ``cfg`` from seed-``seed`` weights on the seeded token
    pipeline.  Returns ``first_loss``, ``final_loss``, ``losses``, the
    steps' ``grad_norms`` and ``step_times`` (seconds; each step ends
    in a host read of its loss and norm, so on the card it is
    synchronised), and the final ``state`` (params, optimizer state)."""
    model = S.build_model(cfg, Runtime(), device=device)
    opt = make_optimizer(lr, steps)
    params = model.init_params(seed)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in T.leaves(params))
    print(f"arch={cfg.name} layers={cfg.n_layers} "
          f"params={n_params / 1e6:.1f}M device={model.device}")

    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed))
    train_step = S.make_train_step(model, opt)

    def batch_for(step: int) -> dict:
        out = {k: torch.from_numpy(v).to(model.device, torch.long)
               for k, v in pipe.batch_at(step).items()}
        if cfg.family == "encdec":
            out["frames"] = side_embeds(cfg, cfg.encoder.n_frames, batch,
                                        seed, step, model.device)
        if cfg.n_prefix_embeds:
            out["prefix_embeds"] = prefix_embeds(cfg, batch, seed, step,
                                                 model.device)
        return out

    losses, grad_norms, step_times = [], [], []

    def step_fn(state, batch):
        params, opt_state, info = train_step(*state, batch)
        return (params, opt_state), {"loss": float(info["loss"]),
                                     "grad_norm": float(info["grad_norm"])}

    def on_step(step, metrics):
        losses.append(metrics["loss"])
        grad_norms.append(metrics["grad_norm"])
        step_times.append(metrics["step_time"])
        if step % log_every == 0:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"{metrics['step_time'] * 1e3:.0f}ms")

    state = (params, opt_state)
    if ckpt_dir:
        runner = StepRunner(step_fn=step_fn, batch_at=batch_for,
                            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                            on_step=on_step)
        state, _ = runner.run(state, steps)
    else:
        for step in range(steps):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch_for(step))
            m["step_time"] = time.perf_counter() - t0
            on_step(step, m)

    print(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f})")
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "losses": losses, "grad_norms": grad_norms,
            "step_times": step_times, "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=sorted(ALIASES) + ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke, CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient reduction over a "
                         "data axis: not ported yet")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    if args.model_axis != 1:
        ap.error("--model-axis other than 1 needs a device mesh, which "
                 "the port's distributed slice brings (ROADMAP Queue 1 "
                 "item 4)")
    if args.compress_grads:
        ap.error("--compress-grads reduces gradients over a data axis, "
                 "which the port's distributed slice brings (ROADMAP "
                 "Queue 1 item 4)")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("no CUDA device: train on the card, or pass --device cpu")

    cfg = get_config(args.arch, smoke=not args.full)
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, seed=args.seed,
                log_every=args.log_every, device=args.device)
    return {k: out[k] for k in ("first_loss", "final_loss", "losses")}


if __name__ == "__main__":
    main()
