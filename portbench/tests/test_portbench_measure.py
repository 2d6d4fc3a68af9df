"""The end-to-end metrics' arithmetic on synthetic step logs, and the
FLOP and byte counts at both cells' shapes, worked by hand."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import cost, measure, spec
from portbench.harness.drive import Run, Served, StepRec
from portbench.harness.traffic import Request

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _model(name: str) -> tuple:
    """(the configuration's architecture, its model dict)."""
    with open(CONFIGS / f"{name}.json", encoding="utf-8") as f:
        c = json.load(f)
    return spec.architecture(c), c["model"]


def _run(walls, n_req=2, due=None, seconds=None):
    """Requests 0..n_req-1 each gain a token at every step's return; the
    steps take ``walls`` seconds one after another from t=0; the window
    is [0, seconds)."""
    seconds = seconds if seconds is not None else sum(walls)
    offered = [Request(np.zeros(4, np.int64), 100, 4,
                       0.0 if due is None else due[i])
               for i in range(n_req)]
    served = [Served(r, i, 0.0, None if due is None else r.due_s)
              for i, r in enumerate(offered)]
    steps, t = [], 0.0
    for w in walls:
        rec = StepRec(t, t + w, [], [5] * n_req, n_req)
        t += w
        for s in served:
            s.events.append((t, 1))
        steps.append(rec)
    inside = [s for s in steps if s.t1 <= seconds]
    return Run(None, {}, seconds, 0.0, seconds, inside, steps, served, {},
               {}, set(), offered=offered if due is not None else [])


def test_steady_steps():
    run = _run([0.01] * 100, seconds=1.0 + 1e-9)
    assert measure.out_tok_s(run) == pytest.approx(200.0)
    assert measure.itl_p95_ms(run) == pytest.approx(10.0)
    assert measure.itl_p50_ms(run) == pytest.approx(10.0)
    assert measure.decode_step_ms(run) == pytest.approx(10.0)


def test_a_stall_moves_every_end_to_end_metric():
    calm = _run([0.01] * 100, due=[0.5, 0.5], seconds=1.0)
    stall = _run([0.01] * 40 + [0.3] + [0.01] * 59, due=[0.5, 0.5],
                 seconds=1.0)
    assert measure.out_tok_s(stall) < 0.8 * measure.out_tok_s(calm)
    assert max(measure.itl_gaps(stall)) == pytest.approx(0.3)
    # one stalled gap in 140 lies past the 95th percentile's rank; a
    # stall in every tenth step moves it
    many = _run(([0.01] * 9 + [0.2]) * 10, due=[0.5, 0.5], seconds=2.0)
    assert measure.itl_p95_ms(many) > 10 * measure.itl_p95_ms(calm)
    # a request due at 0.405 s waits through the stall for its first token
    late = _run([0.01] * 40 + [0.3] + [0.01] * 59, due=[0.405, 0.405],
                seconds=1.0)
    late.served[0].events = [e for e in late.served[0].events
                             if e[0] > 0.405]
    late.served[1].events = list(late.served[0].events)
    early = _run([0.01] * 100, due=[0.405, 0.405], seconds=1.0)
    early.served[0].events = [e for e in early.served[0].events
                              if e[0] > 0.405]
    early.served[1].events = list(early.served[0].events)
    assert measure.ttft_p95_ms(late) > 250
    assert measure.ttft_p50_ms(late) > 250
    assert measure.ttft_p95_ms(early) < 10
    assert measure.ttft_p50_ms(early) < 10
    # a stall that runs past the close: requests that fall due during it
    # are never submitted, and each still counts its wait to the close
    past = _run([0.01] * 40 + [0.9], due=[0.0, 0.0], seconds=1.0)
    past.offered += [Request(np.zeros(4, np.int64), 100, 4, d)
                     for d in (0.5, 0.6, 0.95, 1.2)]
    assert sorted(measure.ttfts(past)) == pytest.approx(
        [0.01, 0.01, 0.05, 0.4, 0.5])
    assert measure.ttft_p50_ms(past) > 4 * measure.ttft_p50_ms(early)


def test_open_gap_and_unserved_wait_count():
    run = _run([0.01] * 10, n_req=1, due=[0.02], seconds=0.5)
    # still running at the close: the open gap from 0.1 s to 0.5 s
    assert max(measure.itl_gaps(run)) == pytest.approx(0.4)
    never = _run([0.01] * 10, n_req=1, due=[0.3], seconds=0.5)
    never.served[0].events = []
    assert measure.ttfts(never) == [pytest.approx(0.2)]


def test_steps_after_the_close_do_not_count():
    run = _run([0.01] * 10, seconds=0.055)
    assert measure.out_tok_s(run) == pytest.approx(2 * 5 / 0.055)


def test_qwen3_counts_by_hand():
    arch, m = _model("qwen3-8b.planned")
    proj = 2 * 4096 * (4096 + 2 * 1024) + 2 * 4096 * 4096
    ffn = 2 * 3 * 4096 * 12288
    assert (proj, ffn) == (83_886_080, 301_989_888)
    assert arch.decode_flops(m, 1000) == \
        36 * (proj + ffn + 4 * 32 * 128 * 1000) + 2 * 4096 * 151936
    assert arch.decode_flops(m, 1000) == 15_726_018_560
    assert arch.prefill_flops(m, 512) == 7_191_170_908_160
    flops, nbytes = cost.mlp_launch(m, 32)
    assert (flops, nbytes) == (9_663_676_416, 302_514_176)
    assert cost.bound_s(flops, nbytes, "bfloat16") == \
        pytest.approx(302_514_176 / 3.35e12)
    flops, nbytes = cost.mlp_launch(m, 4096)
    assert cost.bound_s(flops, nbytes, "bfloat16") == \
        pytest.approx(2 * 3 * 4096 * 4096 * 12288 / 989e12)


def test_olmoe_counts_by_hand():
    arch, m = _model("olmoe-1b-7b")
    proj = 2 * 2048 * 6144 + 2 * 2048 * 2048
    ffn = 2 * 2048 * 64 + 8 * 2 * 3 * 2048 * 1024
    assert (proj, ffn) == (33_554_432, 100_925_440)
    assert arch.decode_flops(m, 2000) == \
        16 * (proj + ffn + 8192 * 2000) + 206_045_184
    flops, nbytes = cost.attn_decode_launch(m, [1000, 2000])
    assert flops == 24_576_000
    assert nbytes == (2 * 16 * 128 * 3000 + 2 * 2 * 16 * 128) * 2
    assert cost.bound_s(flops, nbytes, "bfloat16") == \
        pytest.approx(24_592_384 / 3.35e12)
