"""zamba2 training parity at pp = 1, the longer runs: the PyTorch port
against the JAX reference on the CPU, on the SMOKE config at T = 24 (the
helpers and inputs of tests/test_torch_zamba2.py, which holds the fp32
loss steps, the layout and the collectives).

  * loss and every storage gradient against the reference's
    `parallelize(...).loss_step()` in bf16 at TOL (2e-2);
  * 3 chained AdamW steps through the port's `Trainer` at TOL32 (rtol
    2e-4, atol 2e-5), and a checkpoint written by the reference after step
    2 resumed by the port;
  * the launcher trains zamba2 on the CPU end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import api as japi
from repro.core.dist import single_device_config as jax_single_device_config
from repro.models import runtime as JRT
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.optim.adamw import AdamWConfig as JAdamWConfig, init_opt_state
from repro.train.train_step import default_schedule as jax_default_schedule

from repro_torch.core.dist import DistConfig
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig

from tests.test_torch_zamba2 import (ARCH, B, S, STEPS, TOL, TOL32, WARMUP,
                                     _batch, _close, _port, _reference)

torch.set_num_threads(1)  # small tensors: spare the test workers' cores


def test_bf16_loss_and_grads_match_reference():
    storage_np, batch, want_loss, want_grads = _reference(torch.bfloat16)
    model, dcfg, par = _port(dtype=torch.bfloat16)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    loss, grads = par.loss_step()(storage, batch)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    _close(grads, want_grads, "bf16 grad", TOL)


def test_chained_steps_and_checkpoint_resume_match_reference(tmp_path):
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    jdcfg = jax_single_device_config(param_dtype=jnp.float32,
                                     reduce_dtype=jnp.float32, reorder=False)
    ocfg = JAdamWConfig()
    par = japi.parallelize(jmodel, jdcfg, JShapeConfig("t", S, B, "train"))
    step_fn = par.train_step(ocfg, jax_default_schedule(ocfg, STEPS, WARMUP),
                             donate=False)
    storage = JRT.init_storage(jmodel, jax.random.PRNGKey(0), jdcfg)
    opt = init_opt_state(storage)
    init = jax.tree.map(np.asarray, storage)
    want = []
    for step in range(STEPS):
        if step == STEPS - 1:
            JCheckpointer(str(tmp_path)).save(step, storage, opt, jmodel,
                                              jdcfg)
        storage, opt, m = step_fn(storage, opt, {
            k: jnp.asarray(v) for k, v in _batch(jcfg.vocab, step).items()})
        want.append(jax.tree.map(float, m))

    # the port's Trainer (the launcher's default schedule: the prefetch
    # stack), chained from the same initial storage
    _, model = get_arch(ARCH, smoke=True)
    dcfg = DistConfig(param_dtype=torch.float32)
    trainer = Trainer(model, dcfg, ShapeConfig("t", S, B, "train"),
                      AdamWConfig(), TrainerConfig(
                          total_steps=STEPS, log_every=1, warmup=WARMUP,
                          ckpt_dir=str(tmp_path)), device="cpu")
    tstore = RT.storage_from_jax(init, model, dcfg, device="cpu")
    topt = init_train_state(trainer.par, torch.Generator())[1]
    for step in range(STEPS):
        tstore, topt, m = trainer.step_fn(tstore, topt,
                                          _batch(jcfg.vocab, step))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), want[step][k],
                                       err_msg=f"step {step} {k}", **TOL32)
    _close(tstore, storage, "storage")
    _close(topt["m"], opt["m"], "m")
    _close(topt["v"], opt["v"], "v")

    # the reference's checkpoint of step 2, shared block included, resumed
    rstore, ropt, hist = trainer.run()
    assert [h["step"] for h in hist] == [STEPS]
    np.testing.assert_allclose(hist[0]["loss"], want[-1]["loss"], **TOL32)
    _close(rstore, storage, "resumed storage")
    _close(ropt["v"], opt["v"], "resumed v")


def test_train_launcher_trains_zamba2_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq", "20", "--batch", "2",
                       "--dtype", "float32", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("plan: mesh[data=1xmodel=1]")
    losses = [float(l.split()[3]) for l in lines if l.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (tmp_path / "step_00000002" / "params__shared__wq.npy").exists()
