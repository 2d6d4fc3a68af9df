"""The training entry point — the port of the JAX package's
``repro.launch.train``.

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

On a world: ``--world N`` spawns N ranks itself (``launch.mesh.spawn``,
gloo, as ``launch.serve --shard-model`` does; the JAX package reads its
world from ``jax.devices()``) over an (N / model axis) x model axis
("data", "model") mesh, and trains with the JAX package's rules,
``Rules(data=("data",), model="model", tp="model" if --model-axis > 1
else None)``: every rank holds its shards of the weights and optimizer
state, the step reduces the gradients over the mesh
(``steps.make_train_step``), and rank 0 prints.  ``--world`` defaults
to ``--model-axis`` (one data rank).  ``--compress-grads`` replicates
the params over the world and reduces the gradients over the data dim
with int8 error feedback (``steps.make_compressed_train_step``); it
refuses ``--model-axis`` above 1, as the JAX package does.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --model-axis 2 --world 4 --steps 6 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --compress-grads --world 2 --steps 6 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import tree as T
from ..configs import ALIASES, ARCHS, get_config
from ..data.pipeline import DataConfig, TokenPipeline
from ..dist.collectives import layout_dims
from ..dist.sharding import Rules, mesh_shape
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


def _n_params(model, params) -> int:
    """The whole model's parameter count, from this rank's shards."""
    if model.rt.mesh is None:
        return sum(p.numel() for p in T.leaves(params))
    sizes = mesh_shape(model.rt.mesh)
    out: list = []
    T.map_tree(lambda p, sp: out.append(p.numel() * math.prod(
        sizes[n] for n in layout_dims(sp))), params, model.param_specs())
    return sum(out)


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 4,
          seq: int = 128, lr: float = 3e-4, ckpt_dir: str = "",
          ckpt_every: int = 10, seed: int = 0, log_every: int = 5,
          device="cuda", model_axis: int = 1,
          compress_grads: bool = False) -> dict:
    """Train ``cfg`` from seed-``seed`` weights on the seeded token
    pipeline.  Returns ``first_loss``, ``final_loss``, ``losses``, the
    steps' ``grad_norms`` and ``step_times`` (seconds; each step ends
    in a host read of its loss and norm, so on the card it is
    synchronised), and the final ``state`` (params, optimizer state[,
    residuals]).

    Inside an initialised world (``launch.mesh.init_rank``) it trains
    on the ("data", "model") mesh of ``model_axis`` (module doc): this
    rank's shards, or with ``compress_grads`` replicated params and the
    int8 error-feedback reduction over the data dim; only rank 0
    prints."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if compress_grads and model_axis != 1:
        raise ValueError("--compress-grads shard_maps the data reduction "
                         "with replicated params; tensor parallelism "
                         "(--model-axis > 1) is not supported on that path")
    say = not dist.is_initialized() or dist.get_rank() == 0
    mesh = None
    if world > 1 or model_axis > 1:
        from .mesh import make_host_mesh
        mesh = make_host_mesh(model_axis)
    n_data = world // model_axis
    if mesh is not None and not compress_grads:
        rules = Rules(data=("data",), model="model",
                      tp="model" if model_axis > 1 else None)
        rt = Runtime(rules=rules, mesh=mesh)
    else:
        rt = Runtime()
    model = S.build_model(cfg, rt, device=device)
    opt = make_optimizer(lr, steps)
    params = model.init_params(seed)
    opt_state = opt.init(params)
    if say:
        print(f"arch={cfg.name} layers={cfg.n_layers} "
              f"params={_n_params(model, params) / 1e6:.1f}M "
              f"device={model.device} world={world} "
              f"mesh=data{n_data}xmodel{model_axis}")

    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed))
    if compress_grads:
        if say:
            print(f"gradient compression: int8+EF all-reduce over the data "
                  f"dim ({n_data} shard{'s' if n_data != 1 else ''})")
        train_step = S.make_compressed_train_step(model, opt, mesh)
    else:
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
        # state is (params, opt_state) or, with compress_grads, (params,
        # opt_state, residuals): each step returns the new state leaves
        # followed by the info dict
        out = train_step(*state, batch)
        info = out[-1]
        return tuple(out[:-1]), {"loss": float(info["loss"]),
                                 "grad_norm": float(info["grad_norm"])}

    def on_step(step, metrics):
        losses.append(metrics["loss"])
        grad_norms.append(metrics["grad_norm"])
        step_times.append(metrics["step_time"])
        if say and step % log_every == 0:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"{metrics['step_time'] * 1e3:.0f}ms")

    state = (params, opt_state)
    if compress_grads:
        state = state + (S.init_grad_residuals(params),)
    if ckpt_dir:
        runner = StepRunner(step_fn=step_fn, batch_at=batch_for,
                            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                            on_step=on_step, mesh=mesh,
                            layouts=(S.state_layouts(model, state)
                                     if mesh is not None else None))
        state, _ = runner.run(state, steps)
    else:
        for step in range(steps):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch_for(step))
            m["step_time"] = time.perf_counter() - t0
            on_step(step, m)

    if say:
        print(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f})")
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "losses": losses, "grad_norms": grad_norms,
            "step_times": step_times, "state": state}


def _parse(argv):
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
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks of the model dim (tensor parallelism)")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks to spawn (default: --model-axis); the "
                         "data dim is world / model axis")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient reduction over "
                         "the data dim (dist.compression); needs "
                         "--model-axis 1")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    args.world = args.world or args.model_axis
    if args.compress_grads and args.model_axis != 1:
        ap.error("--compress-grads shard_maps the data reduction with "
                 "replicated params; tensor parallelism (--model-axis "
                 "> 1) is not supported on that path")
    if args.model_axis < 1 or args.world % args.model_axis:
        ap.error(f"--model-axis {args.model_axis} does not divide the "
                 f"world of {args.world}")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("no CUDA device: train on the card, or pass --device cpu")
    return args


def _train(args) -> dict:
    cfg = get_config(args.arch, smoke=not args.full)
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, seed=args.seed,
                log_every=args.log_every, device=args.device,
                model_axis=args.model_axis,
                compress_grads=args.compress_grads)
    return {k: out[k] for k in ("first_loss", "final_loss", "losses")}


def _train_rank(rank: int, argv) -> dict:
    return _train(_parse(argv))


def main(argv=None) -> dict:
    args = _parse(argv)
    if args.world <= 1:
        return _train(args)
    from .mesh import spawn
    return spawn(_train_rank, args.world, argv, device=args.device)[0]


if __name__ == "__main__":
    main()
