"""The port's trainer over several devices and processes, on the CPU: two
processes of one gloo group (one device each) and one process over the
device list ["cpu", "cpu"] give one device's final params within 2e-4
(tests/test_multihost.py's bar), with dropout on; only rank 0 writes.
The twin of tests/test_multihost.py's variant training case."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from pepper_tpu_torch.models.transducer import TransducerConfig
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.train import trainer

from test_torch_polish import one_intra_op_thread  # noqa: F401

REPO = str(pathlib.Path(__file__).resolve().parent.parent)

TRAIN = dict(epochs=2, learning_rate=1e-3, step_size=1000, batch_size=8,
             holdout_fraction=0.25, seed=3)

WORKER = r'''
import sys
sys.path.insert(0, {repo!r})
from pepper_tpu_torch.models.transducer import TransducerConfig
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.parallel import dist
from pepper_tpu_torch.train.trainer import train_model

rank = int(sys.argv[1])
assert dist.init_distributed({address!r}, 2, rank) == (rank, 2)
train_model(PepperOptions(batch_size=8), {image_dir!r},
            {out!r} if rank == 0 else {out!r} + "_rank1",
            config=TransducerConfig(hidden=16, linear_size=32),
            device="cpu", **{train!r})
dist.shutdown_distributed()
print("RANK", rank, "DONE")
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """A labeled store in the layout load_image_dir reads (96 windows)."""
    import h5py

    directory = tmp_path_factory.mktemp("mp_images")
    rng = np.random.RandomState(7)
    with h5py.File(directory / "train.hdf5", "w") as f:
        f["summaries/s0/images"] = rng.randint(
            -20, 21, size=(96, 33, 26)).astype(np.int8)
        f["summaries/s0/type_label"] = rng.randint(
            0, 3, size=96).astype(np.uint8)
    return str(directory)


def _final(out_dir):
    data = np.load(os.path.join(out_dir, "pepper_model_final.npz"))
    return {key: data[key] for key in data.files if key != "__meta__"}


def _one_process(image_dir, out_dir, devices):
    trainer.train_model(PepperOptions(batch_size=8), image_dir, out_dir,
                        config=TransducerConfig(hidden=16, linear_size=32),
                        devices=devices, **TRAIN)
    return _final(out_dir)


def _assert_close(ours, reference):
    assert sorted(ours) == sorted(reference)
    for key, value in reference.items():
        np.testing.assert_allclose(ours[key], value, atol=2e-4, err_msg=key)


def test_two_devices_give_one_device_params(image_dir, tmp_path):
    one = _one_process(image_dir, str(tmp_path / "one"), ["cpu"])
    _assert_close(_one_process(image_dir, str(tmp_path / "two"),
                               ["cpu", "cpu"]), one)


def test_two_gloo_processes_give_one_process_params(image_dir, tmp_path):
    out = str(tmp_path / "dist")
    script = WORKER.format(repo=REPO, address=f"127.0.0.1:{_free_port()}",
                           image_dir=image_dir, out=out, train=TRAIN)
    # one intra-op thread a process: two busy processes spinning on every
    # core of a shared host would slow each other tens of times
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for rank in (0, 1)]
    outputs = []
    for proc in procs:
        try:
            outputs.append(proc.communicate(timeout=240)[0].decode())
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
    for proc, text in zip(procs, outputs):
        assert proc.returncode == 0, text[-3000:]
    # rank 1 wrote nothing (rank-0-only writes); its directory may exist
    assert os.listdir(out + "_rank1") == []
    assert {"pepper_model_final.npz", "train_loss.csv",
            "confusion_matrix.txt"} <= set(os.listdir(out))
    reference = _one_process(image_dir, str(tmp_path / "one"), ["cpu"])
    _assert_close(_final(out), reference)
