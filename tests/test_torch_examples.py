"""The port's three example drivers on the CPU (``--device cpu``), at
SMOKE size: ``repro_torch.launch.fuse_custom_chain`` (under ``V5E`` the
JAX example's candidate counts and winning schedule; under ``H100`` a
winner inside one block's shared memory), ``serve_batched`` (fixed
batching, ``--continuous``, and ``--shard-model 2`` on a spawned gloo
world, whose greedy tokens equal one process's) and ``train_lm`` (the
loss falls over the example's 200 steps).  None of them falls back to
the CPU: without a card their default ``--device cuda`` raises.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import fuse_custom_chain, serve_batched  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402

NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the refusal without a card")


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    from repro_torch.core import api, planner
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    api.clear_cache()
    planner.clear_memo()
    yield
    api.clear_cache()
    planner.clear_memo()


def test_fuse_custom_chain_matches_the_reference_under_v5e():
    """Under ``V5E`` the example reports the JAX example's pruning
    counts, winner, tiles and estimate."""
    pytest.importorskip("jax")
    from repro.core.chain import gemm_chain3
    from repro.core.perf_model import V5E, estimate
    from repro.core.pruning import PruneStats, generate_candidates
    from repro.core.search import heuristic_search
    got = fuse_custom_chain.main(["--hw", "v5e", "--device", "cpu"])
    ch = gemm_chain3(M=1024, N=512, K=64, H=64, G=64, dtype="bfloat16")
    stats = PruneStats()
    cands = generate_candidates(ch, stats=stats)
    rep = heuristic_search(ch, seed=0)
    assert (got["n_total"], got["n_kept"], got["n_rule2"], got["n_rule3"],
            got["n_rule4"], got["n_candidates"]) == (
        stats.n_total, stats.n_kept, stats.n_rule2, stats.n_rule3,
        stats.n_rule4, len(cands))
    assert got["best"] == rep.best.sub_expr()
    assert got["grid"] == tuple(rep.best.grid)
    assert got["tile_sizes"] == dict(rep.best.tile_sizes)
    assert got["estimate_s"] == estimate(rep.best, V5E)
    assert (got["n_measured"], got["n_iterations"]) == (rep.n_measured,
                                                        rep.n_iterations)


def test_fuse_custom_chain_under_h100(capsys):
    """The default descriptor: a winner inside one thread block's shared
    memory, reported in place of VMEM."""
    from repro_torch.core.perf_model import H100
    got = fuse_custom_chain.main(["--device", "cpu"])
    assert got["hw"] == H100.name and got["n_kept"] > 0
    assert 0 < got["on_chip_bytes"] <= H100.rule4_budget
    out = capsys.readouterr().out
    assert "shared memory per block" in out and "tensor cores" in out


@NO_CARD
@pytest.mark.parametrize("main", [fuse_custom_chain.main, serve_batched.main,
                                  train_lm.main])
def test_examples_run_on_the_card_by_default(main, tmp_path):
    # train's CLI refuses through its parser (SystemExit)
    with pytest.raises((RuntimeError, SystemExit)):
        main(["--ckpt-dir", str(tmp_path)] if main is train_lm.main
             else [])


def test_serve_batched_fixed_default_arch():
    """The example's default architecture (mixtral-8x7b SMOKE), fixed
    batching: every row decodes ``--gen`` tokens."""
    got = serve_batched.main(["--device", "cpu", "--gen", "8"])
    assert got["mode"] == "fixed" and got["counts"] == [8] * 4
    assert len(got["first"]) == 8


def test_serve_batched_continuous():
    got = serve_batched.main(["--device", "cpu", "--arch", "qwen3-8b",
                              "--continuous", "--batch", "2",
                              "--prompt-len", "12", "--gen", "6",
                              "--page-size", "4"])
    assert got["mode"] == "continuous" and len(got["counts"]) == 6
    assert all(1 <= c <= 6 for c in got["counts"])
    assert got["regime"] == "paged-spatial" and got["tier"] == "configured"


def test_serve_batched_sharded_equals_one_process():
    """``--shard-model 2`` spawns two gloo ranks and serves over a 1 x 2
    mesh: the greedy tokens of one process's run."""
    argv = ["--device", "cpu", "--arch", "qwen3-8b", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    one = serve_batched.main(argv)
    two = serve_batched.main(argv + ["--shard-model", "2"])
    assert two["counts"] == one["counts"] == [4, 4]
    assert two["first"] == one["first"]


def test_train_lm_loss_falls(tmp_path):
    """The example's defaults (200 steps, a checkpoint every 50): the
    loss falls and the checkpoints land."""
    got = train_lm.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert got["final_loss"] < got["first_loss"]
    assert len(got["losses"]) == 200
    assert any(tmp_path.iterdir())
