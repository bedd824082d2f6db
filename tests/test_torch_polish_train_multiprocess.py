"""The port's polish trainer over several devices and processes, on the
CPU: two processes of one gloo group (one device each) and one process
over the device list ["cpu", "cpu"] give one device's final params within
2e-4 (tests/test_multihost.py's bar), at a batch of 5 chunks padded to 6,
so the two halves hold 3 and 2 real rows (a mean of per-device means would
weight them apart); only rank 0 writes.  The twin of
tests/test_multihost.py's polish case."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.polish import train

from test_torch_polish import one_intra_op_thread  # noqa: F401

REPO = str(pathlib.Path(__file__).resolve().parent.parent)

# 6 chunks, one held out: one training batch of 5, padded to 6
TRAIN = dict(epochs=1, learning_rate=1e-3, weight_decay=1e-4, batch_size=8,
             holdout_fraction=0.2, seed=3)

WORKER = r'''
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.parallel import dist
from pepper_tpu_torch.polish.train import train_polish_on_arrays

rank = int(sys.argv[1])
assert dist.init_distributed({address!r}, 2, rank) == (rank, 2)
arrays = np.load({arrays!r})
train_polish_on_arrays(PepperOptions(), arrays["images"], arrays["labels"],
                       {out!r} if rank == 0 else {out!r} + "_rank1",
                       device="cpu", **{train!r})
dist.shutdown_distributed()
print("RANK", rank, "DONE")
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """6 seeded chunks (counts 0..40, labels 0..4), also as an .npz."""
    rng = np.random.RandomState(11)
    images = rng.randint(0, 41, (6, 1000, 10)).astype(np.float32)
    labels = rng.randint(0, 5, (6, 1000)).astype(np.int32)
    path = str(tmp_path_factory.mktemp("mp_polish") / "chunks.npz")
    np.savez(path, images=images, labels=labels)
    return images, labels, path


def _final(out_dir):
    data = np.load(os.path.join(out_dir, "polish_model_final.npz"))
    return {key: data[key] for key in data.files if key != "__meta__"}


def _one_process(chunks, out_dir, devices):
    images, labels, _ = chunks
    train.train_polish_on_arrays(PepperOptions(), images, labels, out_dir,
                                 devices=devices, **TRAIN)
    return _final(out_dir)


def _assert_close(ours, reference):
    assert sorted(ours) == sorted(reference)
    for key, value in reference.items():
        np.testing.assert_allclose(ours[key], value, atol=2e-4, err_msg=key)


def test_two_devices_give_one_device_params(chunks, tmp_path):
    one = _one_process(chunks, str(tmp_path / "one"), ["cpu"])
    _assert_close(_one_process(chunks, str(tmp_path / "two"),
                               ["cpu", "cpu"]), one)


def test_two_gloo_processes_give_one_process_params(chunks, tmp_path):
    out = str(tmp_path / "dist")
    script = WORKER.format(repo=REPO, address=f"127.0.0.1:{_free_port()}",
                           arrays=chunks[2], out=out, train=TRAIN)
    # one intra-op thread a process (tests/test_torch_train_multiprocess.py)
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
        assert "MULTI-HOST POLISH TRAINING" in text
    # rank 1 wrote nothing (rank-0-only writes); its directory may exist
    assert os.listdir(out + "_rank1") == []
    assert sorted(os.listdir(out)) == ["polish_epoch_1_checkpoint.npz",
                                       "polish_model_final.npz"]
    reference = _one_process(chunks, str(tmp_path / "one"), ["cpu"])
    _assert_close(_final(out), reference)
