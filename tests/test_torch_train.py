"""The port's trainer (``repro_torch.runtime``, ``launch/train.py`` and
``examples/train_lm.py``) against the reference's on the CPU.

granite's smoke configuration in float32, its parameters drawn by the
port and carried to the reference's tree; batches are numpy, fed to
both packages. Tolerances:

- the loss and its metrics within 1e-5 (the forward's tolerance), the
  learning rate and the pre-clip gradient norm within 1e-5 relative;
- the parameters after a step within ``0.2·lr`` for each step taken:
  AdamW's update ``m̂/(√v̂ + eps)`` is about ±1 for every entry at the
  first steps, so an entry whose gradient is as small as the rounding
  of its leaf (1e-4 of the leaf's largest |g|, as
  ``test_torch_train_grads.py`` holds it) can move by an ``lr``-sized
  amount on one side and less on the other (observed: ≤ 0.11·lr a step).

The port's loop resumed after a kill equals its uninterrupted run bit
for bit.
"""
import dataclasses
import importlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as RMODEL
from repro.optim import adamw as RADAM
from repro.runtime.train_loop import TrainLoopConfig as RefLoopConfig
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro.runtime.train_loop import train_loop as ref_train_loop
from repro_torch import configs as port_configs
from repro_torch.checkpoint import latest_step
from repro_torch.examples import train_lm
from repro_torch.launch import train as port_launch
from repro_torch.models import model as PMODEL
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime import StepWatchdog, TrainLoopConfig, train_loop
from repro_torch.runtime.train_loop import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPT = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
STEP_TOL = 0.2 * OPT.lr


@pytest.fixture(scope="module")
def granite():
    rcfg = dataclasses.replace(ref_configs.get_smoke("granite_8b"),
                               dtype="float32")
    pcfg = dataclasses.replace(port_configs.get_smoke("granite-8b"),
                               dtype="float32")
    tree = PMODEL.params_to_numpy(PMODEL.init_params(pcfg, 0, device="cpu"))
    return rcfg, pcfg, tree


def batch_fn(step, batch=4, seq=16):
    rng = np.random.default_rng(100 + step)
    return {k: rng.integers(0, 512, (batch, seq)).astype(np.int32)
            for k in ("tokens", "labels")}


def _same_params(model, ref_params, atol):
    got = PMODEL.params_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(ref_params)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref_params),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(granite, microbatches):
    rcfg, pcfg, tree = granite
    rocfg = RADAM.OptConfig(**vars(OPT))
    rparams = jax.tree.map(jnp.asarray, tree)
    rparams, _, rm = jax.jit(ref_make_train_step(rcfg, rocfg, microbatches))(
        rparams, RADAM.init_opt_state(rparams, rocfg),
        jax.tree.map(jnp.asarray, batch_fn(0)))
    model = PMODEL.params_from_numpy(pcfg, tree, "cpu")
    opt = init_opt_state(model, OPT)
    _, opt, m = make_train_step(pcfg, OPT, microbatches)(
        model, opt, {k: torch.from_numpy(v) for k, v in batch_fn(0).items()})
    assert set(m) == set(rm) == {"loss", "ce", "aux", "lr", "grad_norm"}
    for k in ("loss", "ce", "aux"):
        assert abs(float(m[k]) - float(rm[k])) <= 1e-5, k
    for k in ("lr", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
    assert int(opt["step"]) == 1
    _same_params(model, rparams, STEP_TOL)


def test_microbatches_accumulate_in_accum_dtype(granite, monkeypatch):
    """With bfloat16 parameters the microbatch path's gradients add into
    a float32 accumulator (the parameters' own gradients stay bfloat16),
    and the metrics are the reference's ``{"ce": loss, "aux": 0}``."""
    _, pcfg, _ = granite
    cfg = dataclasses.replace(pcfg, dtype="bfloat16")
    model = PMODEL.init_params(cfg, 0, device="cpu")
    seen = []

    def spy(model, grads, opt_state, cfg):
        seen.extend(g.dtype for g in grads.values())
        return opt_state, {"lr": torch.zeros(()),
                           "grad_norm": torch.zeros(())}

    monkeypatch.setattr(
        importlib.import_module("repro_torch.runtime.train_loop"),
        "opt_update", spy)
    _, _, m = make_train_step(cfg, OPT, 2)(
        model, init_opt_state(model, OPT),
        {k: torch.from_numpy(v) for k, v in batch_fn(0).items()})
    assert set(seen) == {torch.float32}
    assert float(m["aux"]) == 0 and float(m["ce"]) == float(m["loss"])


def test_train_loop_resume_after_kill(granite, tmp_path):
    """The loop runs 6 steps; then 4 steps with checkpoints every 2, a
    'kill', and a new loop on the same directory that resumes at 4 and
    ends at 6. The resumed run equals the uninterrupted one bit for bit
    and the reference's 6-step run within the stated tolerance; the
    caller's model is left as it was."""
    rcfg, pcfg, tree = granite
    model0 = PMODEL.params_from_numpy(pcfg, tree, "cpu")
    whole, whole_opt, info = train_loop(
        pcfg, OPT, TrainLoopConfig(steps=6, ckpt_every=0, log_every=1),
        model0, batch_fn)
    assert [r["step"] for r in info["history"]] == list(range(6))

    d = str(tmp_path / "ckpt")
    train_loop(pcfg, OPT, TrainLoopConfig(steps=4, ckpt_every=2, ckpt_dir=d),
               model0, batch_fn)
    assert latest_step(d) == 4
    resumed, resumed_opt, info = train_loop(
        pcfg, OPT, TrainLoopConfig(steps=6, ckpt_every=2, ckpt_dir=d,
                                   log_every=1), model0, batch_fn)
    assert [r["step"] for r in info["history"]] == [4, 5]
    assert latest_step(d) == 6
    for (n, a), (_, b) in zip(whole.named_parameters(),
                              resumed.named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n in whole_opt[k]:
            assert torch.equal(whole_opt[k][n], resumed_opt[k][n]), (k, n)
    assert int(resumed_opt["step"]) == 6

    for (n, p), (_, p0) in zip(
            model0.named_parameters(),
            PMODEL.params_from_numpy(pcfg, tree, "cpu").named_parameters()):
        assert torch.equal(p, p0), n

    rparams, _, _ = ref_train_loop(
        rcfg, RADAM.OptConfig(**vars(OPT)),
        RefLoopConfig(steps=6, ckpt_every=0, ckpt_dir=None),
        jax.tree.map(jnp.asarray, tree),
        lambda s: jax.tree.map(jnp.asarray, batch_fn(s)))
    _same_params(resumed, rparams, 6 * STEP_TOL)


def test_watchdog_flags_stragglers():
    seen = []
    wd = StepWatchdog(threshold=3.0, warmup=3,
                      on_straggler=lambda s, dt, med: seen.append(s))
    for i in range(10):
        wd.record(i, 0.1)
    wd.record(10, 0.95)
    assert seen == [10]
    assert wd.stragglers[0][0] == 10


def test_watchdog_tolerates_drift():
    wd = StepWatchdog(threshold=3.0, warmup=3)
    for i in range(50):
        wd.record(i, 0.1 + i * 0.001)
    assert wd.stragglers == []


def test_launcher_trains_smoke_config(tmp_path, capsys):
    info = port_launch.main(["--arch", "granite-8b", "--smoke", "--steps",
                             "3", "--microbatches", "2", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("[train] granite-smoke: ")
    assert out.count("[train] ") == 2 and "stragglers=0" in out
    assert [r["step"] for r in info["history"]] == [0, 2]
    assert all(np.isfinite(r["loss"]) for r in info["history"])
    assert latest_step(str(tmp_path)) == 3
    b = port_launch.synthetic_batches(
        port_configs.get_smoke("whisper-small"), 2, 8)(5)
    assert b["frames"].dtype == torch.bfloat16
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_example_matches_reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_train_lm", ROOT / "examples" / "train_lm.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    rcfg, pcfg = ref.make_config(), train_lm.make_config()
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    assert PMODEL.param_count(pcfg) == RMODEL.param_count(rcfg)
    want, got = ref.token_pipeline(rcfg), train_lm.token_pipeline(pcfg)
    for s in range(3):
        w, g = want(s), got(s)
        assert set(w) == set(g) == {"tokens", "labels"}
        for k in w:
            assert g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
