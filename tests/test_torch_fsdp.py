"""FSDP2 training under ``torchrun`` on the CPU (two gloo processes on a
(2, 1) ``("data", "model")`` mesh) against the launcher run alone, and a
world of one rank in this process against the unsharded step.

The launcher runs with the smoke config's activations in float32: the
two runs then agree, the same printed losses and checkpoints within
1e-5 of each leaf's scale. In the smoke config's bf16 activations each
rank's partial weight gradient is rounded to bf16 before the ranks'
mean, which AdamW's first steps turn into lr-sized updates of the
elements where the two halves cancel, so that config is not compared
for equality."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train as launch_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "deepseek-7b", "--steps", "3", "--batch", "4", "--seq",
        "32", "--device", "cpu"]
# the launcher with the smoke config's activations in float32
F32 = """import sys
import repro_torch.launch.train as t
smoke = t.get_smoke_config
t.get_smoke_config = lambda arch: smoke(arch).replace(dtype="float32")
t.main(sys.argv[1:])
"""


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke steps run one intra-op thread: the tier-1 run shares the
    cores among its workers, where spinning thread pools cost more than
    they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steps(out: str):
    """(loss, grad norm) of each printed step line."""
    rows = [ln.split() for ln in out.splitlines() if ln.startswith("step ")]
    return [(float(r[3]), float(r[7])) for r in rows]


def _torchrun(script, ckpt):
    """``script`` under ``torchrun`` in two processes; ``--standalone``
    rendezvous on a free port of localhost."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", script, *ARGS, "--ckpt", ckpt],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "mesh=(data 2, model 1) fsdp" in out.stdout
    return _steps(out.stdout)


def _alone(capsys, ckpt):
    smoke = launch_train.get_smoke_config
    launch_train.get_smoke_config = \
        lambda arch: smoke(arch).replace(dtype="float32")
    try:
        launch_train.main(ARGS + ["--ckpt", ckpt])
    finally:
        launch_train.get_smoke_config = smoke
    return _steps(capsys.readouterr().out)


def _ckpts(a, b):
    with np.load(a + ".npz") as x, np.load(b + ".npz") as y:
        assert sorted(x.files) == sorted(y.files)
        return {k: (x[k], y[k]) for k in x.files}


def test_two_ranks_match_one_process_in_f32(tmp_path, capsys):
    script = os.path.join(tmp_path, "train_f32.py")
    with open(script, "w") as f:
        f.write(F32)
    one = _alone(capsys, os.path.join(tmp_path, "one"))
    two = _torchrun(script, os.path.join(tmp_path, "two"))
    assert len(one) == len(two) == 3
    assert [l for l, _ in two] == [l for l, _ in one]      # printed losses
    assert two[0][1] > 1 and one[0][1] > 1                  # clip engaged
    for k, (a, b) in _ckpts(os.path.join(tmp_path, "one"),
                            os.path.join(tmp_path, "two")).items():
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        scale = float(np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)


def test_world_of_one_matches_the_unsharded_step():
    """A process group of one rank in this process: the model sharded
    by ``fsdp_shard`` (FSDP2 over the data axis, remat on), its moments
    made by ``adamw_init`` afterwards (DTensors as their parameters),
    trained by ``make_train_step(mesh=)``: losses and parameters after 3
    steps are the unsharded step's, bit for bit. The step refuses a
    model that was not sharded."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.text import lm_batches
    from repro_torch.launch.mesh import make_abstract_mesh, to_device_mesh
    from repro_torch.models.transformer import init_model
    from repro_torch.training import TrainHParams, adamw_init
    from repro_torch.training.trainer import fsdp_shard, make_train_step
    cfg = get_smoke_config("deepseek-7b")
    it = lm_batches(cfg.vocab_size, 2, 32, seed=3)
    batches = [next(it) for _ in range(3)]
    hp = TrainHParams(base_lr=3e-3, warmup=1, total_steps=3, remat=True)

    def run(step, mesh=None):
        model = init_model(cfg, seed=0, device="cpu")
        if mesh is not None:
            model = fsdp_shard(model, mesh)
        opt = adamw_init(dict(model.named_parameters()))
        losses = []
        for i, b in enumerate(batches):
            model, opt, m = step(model, opt, b, i)
            losses.append(float(m["loss"]))
        return model, opt, losses

    want_model, _, want = run(make_train_step(cfg, hp))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        dm = to_device_mesh(make_abstract_mesh((1, 1), ("data", "model")),
                            "cpu")
        step = make_train_step(cfg, hp, mesh=dm)
        with pytest.raises(ValueError, match="fsdp_shard"):
            step(init_model(cfg, seed=0, device="cpu"), None, batches[0], 0)
        model, opt, got = run(step, dm)
        assert isinstance(model, FSDPModule)
        assert all(isinstance(m, DTensor) for m in opt.mu.values())
        assert got == want
        ref = dict(want_model.named_parameters())
        for k, p in model.named_parameters():
            assert torch.equal(p.full_tensor(), ref[k]), k
    finally:
        dist.destroy_process_group()
