"""Chained training steps, checkpoints and restarts: the PyTorch port
against the JAX reference on the CPU, both smoke configs, fp32.

  * 3 chained train steps with microbatches=2 (gradient accumulation),
    global-norm clipping, AdamW and the warmup-cosine schedule: loss,
    grad norm and lr per step, and the final storage, m and v, at TOL32
    (rtol 2e-4, atol 2e-5);
  * a checkpoint written by the reference's `Checkpointer` after step 2 is
    resumed by the port's `Trainer`, whose step 3 lands on the reference's;
  * the port's `Trainer` restarts from its own checkpoint after an
    injected failure and ends bit-exact with an uninterrupted run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import api as japi
from repro.core.dist import single_device_config as jax_single_device_config
from repro.data.pipeline import DataConfig, SyntheticC4
from repro.models import runtime as JRT
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.optim.adamw import AdamWConfig as JAdamWConfig, init_opt_state
from repro.train.train_step import default_schedule as jax_default_schedule

from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves
from repro_torch.ft.failures import InjectedFailures
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)
B, S, STEPS, WARMUP = 4, 16, 3, 1


def _close(got_tree, want_tree, what):
    got, want = named_leaves(got_tree), named_leaves(want_tree)
    assert [n for n, _ in got] == [n for n, _ in want], what
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.detach().cpu().numpy(), np.asarray(b),
                                   err_msg=f"{what} {n}", **TOL32)


def _port_dcfg():
    return DistConfig(param_dtype=torch.float32, reorder=False,
                      microbatches=2)


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_1_7b"])
def test_chained_steps_and_checkpoint_resume_match_reference(arch,
                                                             tmp_path):
    jcfg, jmodel = jax_get_arch(arch, smoke=True)
    jdcfg = jax_single_device_config(param_dtype=jnp.float32,
                                     reduce_dtype=jnp.float32, reorder=False,
                                     microbatches=2)
    ocfg = JAdamWConfig()
    par = japi.parallelize(jmodel, jdcfg, JShapeConfig("t", S, B, "train"))
    step_fn = par.train_step(ocfg, jax_default_schedule(ocfg, STEPS, WARMUP),
                             donate=False)
    storage = JRT.init_storage(jmodel, jax.random.PRNGKey(0), jdcfg)
    opt = init_opt_state(storage)
    data = SyntheticC4(DataConfig(vocab=jcfg.vocab, seq_len=S,
                                  global_batch=B, seed=0))
    init = jax.tree.map(np.asarray, storage)
    want_metrics = []
    for step in range(STEPS):
        if step == STEPS - 1:
            JCheckpointer(str(tmp_path)).save(step, storage, opt, jmodel,
                                              jdcfg)
        storage, opt, m = step_fn(storage, opt, {
            k: jnp.asarray(v) for k, v in data.batch(step).items()})
        want_metrics.append(jax.tree.map(float, m))

    # the port's train step, chained from the same initial storage
    _, model = get_arch(arch, smoke=True)
    dcfg = _port_dcfg()
    trainer = Trainer(model, dcfg, ShapeConfig("t", S, B, "train"),
                      AdamWConfig(), TrainerConfig(
                          total_steps=STEPS, log_every=1, warmup=WARMUP,
                          ckpt_dir=str(tmp_path)), device="cpu")
    tstore = RT.storage_from_jax(init, model, dcfg, device="cpu")
    topt = init_train_state(trainer.par, torch.Generator())[1]
    for step in range(STEPS):
        tstore, topt, m = trainer.step_fn(tstore, topt, data.batch(step))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), want_metrics[step][k],
                                       err_msg=f"step {step} {k}", **TOL32)
    _close(tstore, storage, "storage")
    _close(topt["m"], opt["m"], "m")
    _close(topt["v"], opt["v"], "v")
    assert int(topt["step"]) == int(opt["step"]) == STEPS
    carried = RT.opt_state_from_jax(jax.tree.map(np.asarray, opt), model,
                                    dcfg, device="cpu")
    assert carried["step"].dtype == torch.int32 and int(carried["step"]) == 3
    _close(carried["m"], topt["m"], "carried m")

    # the port's Trainer resumes the reference's checkpoint of step 2
    rstore, ropt, hist = trainer.run()
    assert [h["step"] for h in hist] == [STEPS]
    np.testing.assert_allclose(hist[0]["loss"], want_metrics[-1]["loss"],
                               **TOL32)
    _close(rstore, storage, "resumed storage")
    _close(ropt["v"], opt["v"], "resumed v")


def test_trainer_restarts_bit_exact_after_a_failure(tmp_path):
    _, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("t", S, B, "train")

    def run(ckpt_dir, failures=None):
        tcfg = TrainerConfig(total_steps=4, ckpt_every=1, log_every=1,
                             warmup=WARMUP, ckpt_dir=str(ckpt_dir))
        trainer = Trainer(model, _port_dcfg(), shape, AdamWConfig(), tcfg,
                          failure_source=failures, device="cpu")
        storage, _, hist = trainer.run()
        return trainer, storage, hist

    _, clean, hist = run(tmp_path / "a")
    trainer, resumed, _ = run(tmp_path / "b", InjectedFailures((2,)))
    assert trainer.restarts == 1 and [h["step"] for h in hist] == [1, 2, 3, 4]
    for (n, a), (_, b) in zip(named_leaves(resumed), named_leaves(clean)):
        assert torch.equal(a, b), n
