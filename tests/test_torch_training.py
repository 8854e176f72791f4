"""The port's training half (``repro_torch.data``, ``optim``, ``checkpoint``,
``train``, ``launch.train`` / ``launch.serve``) against the JAX package on
the CPU, on numpy-seeded inputs and JAX's weights carried across with
``repro_torch.convert``.

Tolerances: one AdamW update at 1e-6 relative (float32 elementwise
arithmetic, the bias corrections as float32 powers); the range finder on
JAX's Omega at 1e-5 (a float32 QR); one trainer step at 1e-5 of the
tree's largest parameter (its gradients agree to ~1e-6, see
tests/test_torch_models.py, and AdamW's first step divides each by its own
size); TLR-KFAC's solve against a dense
solve of the damped factor at 1e-4 (the factor is accurate to eps_tlr =
1e-6, the curvature's condition number is ~1e4); TLR-KFAC's parameters
against JAX's update on the same inputs at 1e-7 of the largest parameter
with dense sides (the AdamW step it grafts its norm from is float32) and
at 1e-4 with a TLR side (as the solve). Data, checkpoints and greedy
decode tokens must be equal.
"""

import json
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_checkpoint as jlatest_checkpoint
from repro.checkpoint import restore_checkpoint as jrestore_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import init_model as jinit_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import grad_compress as jgc
from repro.train import DecodeServer as JDecodeServer
from repro.train import Request as JRequest
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import (latest_checkpoint, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.convert import model_from_numpy
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.optim import (AdamWConfig, CompressConfig, TLRNewtonConfig,
                               adamw_init, adamw_update, compress_grads,
                               compress_init, tlr_newton_init,
                               tlr_newton_update)
from repro_torch.optim import grad_compress as gc
from repro_torch.optim.tlr_newton import _leaf_names, damped
from repro_torch.train import DecodeServer, Request, TrainConfig, Trainer
from repro_torch.tree import leaves


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small torch ops a call: one intra-op thread beside the suite's
    other workers. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- data ---------------------------------------------------------------------


def test_batches_are_jax_s_bitwise():
    for kw in ({"vocab_size": 1000, "batch": 4, "seq_len": 32, "seed": 7},
               {"vocab_size": 256, "batch": 8, "seq_len": 64, "seed": 1,
                "doc_len": 16}):
        ds, jds = SyntheticTokens(DataConfig(**kw)), \
            JSyntheticTokens(JDataConfig(**kw))
        for step, hosts in ((0, 1), (5, 1), (3, 2)):
            for h in range(hosts):
                got = ds.batch_at(step, host_index=h, host_count=hosts)
                want = jds.batch_at(step, host_index=h, host_count=hosts)
                for k in ("tokens", "labels"):
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])


# -- optimizers ------------------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((16, 8)).astype(np.float32),
         "b": [rng.standard_normal(8).astype(np.float32)]}
    g = {"w": rng.standard_normal((16, 8)).astype(np.float32) * 3,
         "b": [rng.standard_normal(8).astype(np.float32)]}
    jcfg = JAdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    cfg = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    jp, jg = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g)
    tp, tg = model_from_numpy(p, "cpu"), model_from_numpy(g, "cpu")
    js, st = jadamw_init(jp, jcfg), adamw_init(tp, cfg)
    for _ in range(3):     # the clip is active (gnorm > 1) at every step
        jp, js = jadamw_update(jg, js, jp, jcfg)
        tp, st = adamw_update(tg, st, tp, cfg)
    assert int(st.step) == int(js.step) == 3
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        assert rel(a, b) <= 1e-6
    for a, b in zip(leaves(st.m) + leaves(st.v),
                    jax.tree.leaves(js.m) + jax.tree.leaves(js.v)):
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        assert rel(a, np.asarray(b, np.float32)) <= 1e-6


def test_lowrank_pass_on_jax_omega():
    """compress_grads' range finder with JAX's Omega: Q B^T at 1e-5."""
    rng = np.random.default_rng(1)
    G = rng.standard_normal((96, 80)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    JQ, JB = jgc._lowrank_pass(jnp.asarray(G), 8, key)
    Om = np.array(jax.random.normal(key, (80, 8), jnp.float32))
    Q, B = gc._lowrank_pass(torch.from_numpy(G), torch.from_numpy(Om))
    assert rel(Q @ B.T, np.asarray(JQ @ JB.T)) <= 1e-5


def test_compress_stats_match_jax():
    ccfg = CompressConfig(rank=4, min_size=256)
    jccfg = jgc.CompressConfig(rank=4, min_size=256)
    rng = np.random.default_rng(2)
    g = {"emb": rng.standard_normal((64, 32)).astype(np.float32),
         "stack": rng.standard_normal((2, 32, 32)).astype(np.float32),
         "vec": rng.standard_normal(300).astype(np.float32)}
    jg = jax.tree.map(jnp.asarray, g)
    _, _, jstats = jgc.compress_grads(jg, jgc.compress_init(jg, jccfg),
                                      jccfg, jax.random.PRNGKey(0))
    tg = model_from_numpy(g, "cpu")
    out, st, stats = compress_grads(tg, compress_init(tg, ccfg), ccfg,
                                    torch.Generator().manual_seed(0))
    for k in ("payload_bytes", "raw_bytes", "ratio"):
        assert stats[k] == jstats[k]
    assert stats["compressed"] == [0]          # only the 2-D leaf
    assert torch.equal(out["stack"], tg["stack"])
    assert st.error["emb"].shape == (64, 32) and st.error["vec"].shape == ()
    torch.testing.assert_close(out["emb"] + st.error["emb"], tg["emb"])


def test_compress_error_feedback_converges():
    """Rank-2 compressed GD with error feedback still solves least squares."""
    rng = np.random.default_rng(0)
    W_true = rng.standard_normal((64, 64))
    X = torch.from_numpy(rng.standard_normal((256, 64)))
    Y = X @ torch.from_numpy(W_true)
    W = torch.zeros((64, 64), dtype=torch.float64)
    ccfg = CompressConfig(rank=2, min_size=16)
    cstate = compress_init({"w": W}, ccfg)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(400):
        G = {"w": 2 * X.T @ (X @ W - Y) / 256}
        G, cstate, stats = compress_grads(G, cstate, ccfg, gen)
        W = W - 0.02 * G["w"]
        losses.append(float(((X @ W - Y) ** 2).mean()))
    assert stats["ratio"] > 5
    assert losses[-1] < 0.05 * losses[0], losses[::60]


def test_compress_small_leaves_passthrough():
    ccfg = CompressConfig(rank=4, min_size=10_000)
    g = {"small": torch.ones((8, 8)), "vec": torch.ones((32,))}
    out, _, stats = compress_grads(g, compress_init(g, ccfg), ccfg,
                                   torch.Generator().manual_seed(0))
    assert torch.equal(out["small"], g["small"])
    assert stats["ratio"] == 1.0


def test_tlr_newton_least_squares():
    """TLR-KFAC beats AdamW on an ill-conditioned least-squares problem
    (the gates of tests/test_training.py::test_tlr_newton_least_squares),
    through the TLR branch (n = 128, tile 32), and its solve agrees with a
    dense solve of the damped factor."""
    rng = np.random.default_rng(1)
    n = 128
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    cov = (U * np.geomspace(1, 1e-2, n)) @ U.T
    X = torch.from_numpy(rng.standard_normal((512, n)) @ cov)
    Y = X @ torch.from_numpy(rng.standard_normal((n, n)))

    def loss_and_grad(W):
        R = X @ W.T - Y
        return float((R * R).mean()), 2 * R.T @ X / 512

    ncfg = TLRNewtonConfig(min_dim=64, tile=32, refresh_every=5, beta=0.0,
                           grafting=AdamWConfig(lr=3e-2, weight_decay=0.0))
    params = {"w": torch.zeros((n, n), dtype=torch.float64)}
    nstate = tlr_newton_init(params, ncfg)
    aw = {"w": torch.zeros((n, n), dtype=torch.float64)}
    astate = adamw_init(aw, ncfg.grafting)
    newton, adam = [], []
    for _ in range(30):
        l_n, g_n = loss_and_grad(params["w"])
        newton.append(l_n)
        params, nstate = tlr_newton_update({"w": g_n}, nstate, params, ncfg,
                                           curvature={"w": (X, None)})
        l_a, g_a = loss_and_grad(aw["w"])
        adam.append(l_a)
        aw, astate = adamw_update({"w": g_a}, astate, aw, ncfg.grafting)
    assert newton[-1] < adam[-1], (newton[-5:], adam[-5:])
    assert newton[-1] < 0.2 * newton[0], newton[::6]
    solve = nstate.facts["w"]["A"]
    assert solve.__self__.L.nb == n // 32          # the TLR branch
    A = damped(X.T @ X / 512, ncfg)
    B = torch.from_numpy(rng.standard_normal((n, 3)))
    assert rel(solve(B), torch.linalg.solve(A, B).numpy()) <= 1e-4


def ls_problem(n: int, m: int, batch: int = 512):
    """tests/test_training.py::test_tlr_newton_least_squares's problem
    (ill-conditioned inputs, Y = X W_true^T) with m outputs, and a batch of
    output-side observations for the S factor."""
    rng = np.random.default_rng(1)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    X = rng.standard_normal((batch, n)) @ ((U * np.geomspace(1, 1e-2, n))
                                           @ U.T)
    Y = X @ rng.standard_normal((m, n)).T
    G_obs = rng.standard_normal((batch, m)) * np.geomspace(1, 1e-1, m)
    return X, Y, G_obs


@pytest.mark.parametrize("n,m,steps,tol", [
    # both sides dense (n, m < min_dim); AdamW's step is float32 arithmetic,
    # so the grafted step norm agrees to ~2^-24 of the largest parameter
    (48, 40, 11, 1e-7),
    # the A side TLR (n = 128, tile 32; the ARA probes differ, the factor
    # is accurate to eps_tlr = 1e-6 on a ~1e4-conditioned factor), S dense
    (128, 48, 6, 1e-4),
])
def test_tlr_newton_update_matches_jax(n, m, steps, tol):
    """``tlr_newton_update`` against ``repro.optim.tlr_newton_update`` on
    the same X, params and gradients (the gradient of JAX's iterate, fed to
    both): the EMA (beta 0.5), the damping, the refresh cadence (every 5
    steps), the S-then-A side order and the AdamW grafting norm, with the
    activation factor given as a batch and the output factor as a
    covariance matrix. Parameters after every step, relative to their
    largest entry."""
    from repro.optim import TLRNewtonConfig as JTLRNewtonConfig
    from repro.optim import tlr_newton_init as jtlr_newton_init
    from repro.optim import tlr_newton_update as jtlr_newton_update
    X, Y, G_obs = ls_problem(n, m)
    S_cov = G_obs.T @ G_obs / len(G_obs)
    kw = dict(min_dim=64, tile=32, refresh_every=5, beta=0.5)
    jcfg = JTLRNewtonConfig(**kw, grafting=JAdamWConfig(lr=3e-2))
    cfg = TLRNewtonConfig(**kw, grafting=AdamWConfig(lr=3e-2))
    jp = {"w": jnp.zeros((m, n))}
    tp = {"w": torch.zeros((m, n), dtype=torch.float64)}
    js, ts = jtlr_newton_init(jp, jcfg), tlr_newton_init(tp, cfg)
    errs = []
    for _ in range(steps):
        W = np.asarray(jp["w"])
        g = 2 * (X @ W.T - Y).T @ X / len(X)
        jp, js = jtlr_newton_update({"w": jnp.asarray(g)}, js, jp, jcfg,
                                    curvature={"w": (X, S_cov)})
        tp, ts = tlr_newton_update({"w": torch.from_numpy(g)}, ts, tp, cfg,
                                   curvature={"w": (torch.from_numpy(X),
                                                    S_cov)})
        errs.append(rel(tp["w"], jp["w"]))
    # the TLR branch returns the factorization's bound solve
    assert hasattr(ts.facts["w"]["A"], "__self__") == (n >= 64)
    assert not hasattr(ts.facts["w"]["S"], "__self__")
    assert max(errs) <= tol, errs


def test_tlr_newton_leaf_names_are_jax_s():
    from repro.optim.tlr_newton import _leaf_names as j_leaf_names
    tree = {"blocks": [{"mlp": {"wd": np.zeros((2, 3))}}],
            "emb": {"tok": np.zeros((4, 2))}}
    assert _leaf_names(tree) == j_leaf_names(tree) == \
        ["blocks/0/mlp/wd", "emb/tok"]


# -- checkpoints ---------------------------------------------------------------


def mixed_tree():
    """tests/test_training.py::test_checkpoint_roundtrip_and_keep's tree
    (x64 on: float64 and int64), with bfloat16 values that are not all 0."""
    bf = (np.arange(5) * 0.5 - 1).astype(ml_dtypes.bfloat16)
    jtree = {"a": jnp.arange(12.0).reshape(3, 4),
             "b": [jnp.ones((2,)), jnp.asarray(3)],
             "c": {"d": jnp.asarray(bf)}}
    return jtree, model_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def assert_same(tree, jtree):
    for a, b in zip(leaves(tree), jax.tree.leaves(jtree)):
        if a.dtype == torch.bfloat16:
            assert str(b.dtype) == "bfloat16"
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        else:
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_checkpoint_roundtrip_and_keep(tmp_path):
    _, tree = mixed_tree()
    for step in (1, 2, 3, 4):
        save_checkpoint(tmp_path, step, tree, keep=2, meta={"s": step})
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000003", "step_00000004"]
    step, restored, meta = restore_checkpoint(latest_checkpoint(tmp_path),
                                              tree)
    assert step == 4 and meta["s"] == 4
    for a, b in zip(leaves(restored), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((latest_checkpoint(tmp_path) /
                           "manifest.json").read_text())
    assert manifest["format"] == 2
    assert [lm["id"] for lm in manifest["leaves"]] == \
        ["00000_a", "00001_b_0", "00002_b_1", "00003_c_d"]


def test_checkpoint_atomicity(tmp_path):
    tree = {"w": torch.ones((4, 4))}
    save_checkpoint(tmp_path, 1, tree)
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "junk.npy").write_bytes(b"garbage")
    assert latest_checkpoint(tmp_path).name == "step_00000001"
    save_checkpoint(tmp_path, 2, tree)
    assert latest_checkpoint(tmp_path).name == "step_00000002"


def test_checkpoint_elastic_dtype_cast(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones((4,))})
    _, restored, _ = restore_checkpoint(
        latest_checkpoint(tmp_path), {"w": torch.zeros((4,),
                                                       dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.ones(4))


def test_checkpoints_cross_packages(tmp_path):
    """JAX saves, the port restores; the port saves, JAX restores."""
    jtree, tree = mixed_tree()
    jsave_checkpoint(tmp_path / "jax", 5, jtree, meta={"by": "jax"})
    step, got, meta = restore_checkpoint(
        latest_checkpoint(tmp_path / "jax"), tree)
    assert step == 5 and meta == {"by": "jax"}
    assert_same(got, jtree)
    save_checkpoint(tmp_path / "port", 6, tree, meta={"by": "port"})
    step, jgot, meta = jrestore_checkpoint(
        jlatest_checkpoint(tmp_path / "port"), jtree)
    assert step == 6 and meta == {"by": "port"}
    assert_same(tree, jgot)


# -- trainer ---------------------------------------------------------------------


def tiny(tmp_path, steps, jax_side=False, metrics="m.jsonl"):
    kw = dict(steps=steps, batch=4, seq_len=64, ckpt_dir=str(tmp_path / "ck"),
              save_every=10, log_every=5,
              metrics_path=str(tmp_path / metrics))
    if jax_side:
        return JTrainer(jget_config("qwen1_5_0_5b", smoke=True),
                        JTrainConfig(**kw))
    return Trainer(get_config("qwen1_5_0_5b", smoke=True), TrainConfig(**kw),
                   device="cpu")


def test_trainer_loss_falls_resumes_and_restores_handlers(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    out = tiny(tmp_path, 20).run()
    assert out["status"] == "done" and len(out["losses"]) == 20
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    assert signal.getsignal(signal.SIGTERM) is before
    t2 = tiny(tmp_path, 25)
    out2 = t2.run()
    assert t2.resumed_from == 20 and len(out2["losses"]) == 5
    metrics = [json.loads(x) for x in
               (tmp_path / "m.jsonl").read_text().splitlines()]
    assert any(m["event"] == "resumed" and m["step"] == 20 for m in metrics)
    assert sum(m["event"] == "step" for m in metrics) == 5


def test_trainer_preemption_checkpoint(tmp_path):
    t = tiny(tmp_path, 50)
    orig_check = t._straggler_check

    def preempt_at_7(step, dt):
        orig_check(step, dt)
        if step == 7:
            t._preempted = True   # what the SIGTERM handler sets

    t._straggler_check = preempt_at_7
    out = t.run()
    assert out["status"] == "preempted" and out["step"] == 8
    assert latest_checkpoint(tmp_path / "ck").name == "step_00000008"


def test_trainer_step_matches_jax(tmp_path):
    """One step (value and grad, global norm, AdamW) on JAX's weights and
    batch; then the port resumes from the JAX trainer's checkpoint."""
    jt = tiny(tmp_path, 1, jax_side=True)
    pt = tiny(tmp_path, 1)
    jp = jinit_model(jax.random.PRNGKey(0), jt.cfg)
    p = model_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = jt.data.batch_at(0)
    jstate = jadamw_init(jp, jt.tcfg.optimizer)
    jloss, jgrads, jgnorm = jt._fwd_bwd(jp, jstate, jax.tree.map(
        jnp.asarray, batch))
    jnew, jstate = jt._apply(jgrads, jstate, jp)
    loss, grads, gnorm = pt.fwd_bwd(p, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    new, state = pt.apply(grads, adamw_init(p, pt.tcfg.optimizer), p)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    assert abs(float(gnorm) - float(jgnorm)) <= 1e-5 * float(jgnorm)
    # relative to the tree's largest parameter: AdamW's first step is
    # lr g / (|g| + eps), so on a zero-initialized bias a gradient within
    # ~1e-5 of 0 turns its ~1e-6 error into ~1e-3 of lr
    scale = max(float(np.abs(np.asarray(b)).max())
                for b in jax.tree.leaves(jnew))
    for a, b in zip(leaves(new), jax.tree.leaves(jnew)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5 * scale
    # a checkpoint of the JAX trainer resumes in the port
    jsave_checkpoint(tmp_path / "ck", 1, (jnew, jstate))
    step, (got, _), _ = restore_checkpoint(latest_checkpoint(tmp_path / "ck"),
                                           (new, state))
    assert step == 1
    for a, b in zip(leaves(got), jax.tree.leaves(jnew)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- decode server ------------------------------------------------------------------


def test_decode_server_matches_jax():
    """Greedy tokens equal the JAX package's DecodeServer on the same
    weights, with continuous batching (5 requests of varied prompts through
    2 slots)."""
    jcfg = jget_config("qwen1_5_0_5b", smoke=True)
    cfg = get_config("qwen1_5_0_5b", smoke=True)
    jp = jinit_model(jax.random.PRNGKey(0), jcfg)
    p = model_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = [[1, 2, 3], [5, 6], [7, 8, 9, 10], [11], [4, 4, 4]]
    want = JDecodeServer(jcfg, jp, slots=2, max_len=64).run(
        [JRequest(prompt=q, max_new_tokens=4, rid=i)
         for i, q in enumerate(prompts)])
    srv = DecodeServer(cfg, p, slots=2, max_len=64, device="cpu")
    got = srv.run([Request(prompt=q, max_new_tokens=4, rid=i)
                   for i, q in enumerate(prompts)])
    assert sorted(c.rid for c in got) == [0, 1, 2, 3, 4]
    assert {c.rid: c.tokens for c in got} == {c.rid: c.tokens for c in want}
    assert srv.ticks > 0
    sampled = DecodeServer(cfg, p, slots=2, max_len=64, seed=1,
                           device="cpu").run(
        [Request(prompt=[1, 2], max_new_tokens=5, temperature=0.8, rid=i)
         for i in range(3)])
    assert len(sampled) == 3
    for c in sampled:
        assert len(c.tokens) == 5
        assert all(0 <= x < cfg.vocab_size for x in c.tokens)


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_config("qwen1_5_0_5b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeServer(cfg, {}, slots=1)


# -- launchers ------------------------------------------------------------------------


def test_launchers(tmp_path, capsys):
    launch_train.main(["--arch", "stablelm-1.6b", "--steps", "3", "--batch",
                       "2", "--seq", "32", "--ckpt-dir",
                       str(tmp_path / "ck"), "--compress-rank", "4",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "status=done final_step=3" in out and "loss " in out
    assert latest_checkpoint(tmp_path / "ck").name == "step_00000003"
    launch_serve.main(["--arch", "phi3-mini-3.8b", "--requests", "3",
                       "--slots", "2", "--max-new", "4", "--device", "cpu"])
    assert "3 completions, 12 tokens" in capsys.readouterr().out
    # an SSM family through both launchers
    launch_train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "2",
                       "--batch", "2", "--seq", "32", "--ckpt-dir",
                       str(tmp_path / "ssm"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "status=done final_step=2" in out and "loss " in out
    assert latest_checkpoint(tmp_path / "ssm").name == "step_00000002"
    launch_serve.main(["--arch", "mamba2-130m", "--requests", "3",
                       "--slots", "2", "--max-new", "4", "--device", "cpu"])
    assert "3 completions, 12 tokens" in capsys.readouterr().out
