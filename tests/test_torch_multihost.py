"""The port's parallel tier across processes: gloo ranks on the CPU.

Each test starts one process a rank (``tests/torch_multihost_worker.py``,
which imports neither ``jax`` nor the JAX package), as
``tests/test_multihost.py`` does for the reference, on a free port. Every
process is waited for with ``communicate(timeout=...)`` and every group
has a collective timeout, so no test can hang the suite; the file runs in
~15 s.

- 2 ranks of 2 CPU devices each (the reference's layout): the topology,
  then ``ShardedTrainer.fit`` over the 4-position data mesh on a 16-row
  and a 13-row batch (padded to 16) for 3 epochs: the ranks' params,
  updater state and score bitwise equal, and within 1e-5 of each array's
  largest element of the one-process trainer on a 4-position mesh (the
  gradient sums run in another order), and of the JAX package's
  ``ShardedTrainer`` on its 4 virtual devices within its rtol=2e-4,
  atol=1e-5.
- 4 ranks, a ``seq`` axis over them: ring attention's output blocks and
  the gradients of sum(out * r) for q, k and v, causal and not, against
  dense attention over the whole sequence, to 1e-5 of each array's
  largest element.
- 2 ranks: ``ParallelImageDataSetIterator``'s per-rank shards (the files
  strided by rank, every rank the same number of batches) bitwise the
  JAX package's shards for the same rank.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from deeplearning4j_tpu import nn as J
from deeplearning4j_tpu.optimize import updaters as JU
from deeplearning4j_tpu.parallel import (
    MeshConfig as JMeshConfig, ShardedTrainer as JShardedTrainer)
from deeplearning4j_tpu_torch import parallel as tp
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    _dense_attention)
from torch_parity import close, net_pair, to_np

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_multihost_worker.py"
TIMEOUT = 120      # seconds a rank may take, start-up included
RTOL = 1e-5        # of each array's largest element


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(mode, world, out):
    """Start ``world`` ranks of ``mode``; wait for each; return their
    stdout lines."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, addr, str(world), str(r),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(ROOT)) for r in range(world)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{o}\n{e}"
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _topology(out):
    for line in out.splitlines():
        if line.startswith("TOPOLOGY"):
            return [int(v) for v in line.split()[1:]]
    raise AssertionError(f"TOPOLOGY missing in:\n{out}")


def _dp_conf():
    return (J.NeuralNetConfiguration.Builder().seed(7)
            .updater(JU.Nesterovs(5e-2, 0.9)).list()
            .layer(J.DenseLayer.Builder(nOut=8, activation="tanh").build())
            .layer(J.OutputLayer.Builder().nOut(2).activation("softmax")
                   .build())
            .setInputType(J.InputType.feedForward(4))
            .build())


def test_two_ranks_train_alike_and_as_one_process(tmp_path):
    port, jnet = net_pair(_dp_conf(), seed=7)
    arrays = to_np(port._params)
    np.savez(tmp_path / "dp_init.npz", conf=port.conf.to_json(),
             arrays=np.asarray(arrays, dtype=object))
    rng = np.random.default_rng(0)
    batches = []
    for n in (16, 13):
        X = rng.normal(size=(n, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
        batches.append((X, y))
    np.savez(tmp_path / "dp_data.npz", n=2,
             **{f"{k}{i}": a for i, b in enumerate(batches)
                for k, a in zip("xy", b)})
    outs = _run("dp", 2, tmp_path)
    for i, out in enumerate(outs):
        assert _topology(out) == [i, 2, 2, 4]
    ranks = [np.load(tmp_path / f"dp_{r}.npz") for r in range(2)]
    for r, got in enumerate(ranks):
        # data=4 over 2 x 2 devices: rank r holds data indices 2r, 2r + 1
        assert got["mesh"].tolist() == [4, r, 2 * r, 2 * r + 1]
        assert int(got["iteration"]) == 6
    for key in ("params", "opt", "score"):
        assert ranks[0][key].tobytes() == ranks[1][key].tobytes(), key
    one = port.clone()
    tp.ShardedTrainer(one, tp.MeshConfig(
        data=4, devices=["cpu"] * 4).build()).fit(
        [DataSet(*b) for b in batches], epochs=3)
    close(ranks[0]["params"], one.params().numpy(), RTOL, "params")
    close(float(ranks[0]["score"]), one.score(), RTOL, "score")
    JShardedTrainer(jnet, JMeshConfig(
        data=4, devices=jax.devices()[:4]).build()).fit(batches, epochs=3)
    np.testing.assert_allclose(ranks[0]["params"],
                               np.asarray(jnet.params().numpy()),
                               rtol=2e-4, atol=1e-5)


def test_four_ranks_ring_attention_forward_and_gradients(tmp_path):
    rng = np.random.default_rng(1)
    data = {n: rng.normal(size=(2, 3, 16, 8)).astype(np.float32)
            for n in "qkvr"}
    np.savez(tmp_path / "ring_data.npz", **data)
    outs = _run("ring", 4, tmp_path)
    for i, out in enumerate(outs):
        assert _topology(out) == [i, 4, 1, 4]
    ranks = [np.load(tmp_path / f"ring_{r}.npz") for r in range(4)]
    for causal in (False, True):
        tag = "causal" if causal else "full"
        q, k, v = (torch.tensor(data[n], requires_grad=True) for n in "qkv")
        o = _dense_attention(q, k, v, causal, True)
        grads = torch.autograd.grad((o * torch.tensor(data["r"])).sum(),
                                    (q, k, v))
        for name, want in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            got = np.concatenate([x[f"{tag}_{name}"] for x in ranks], axis=2)
            close(got, want.detach().numpy(), RTOL, f"{tag} {name}")


def test_two_ranks_shard_the_image_tree(tmp_path, monkeypatch):
    from PIL import Image

    from deeplearning4j_tpu.datasets import parallel_etl as jetl
    from deeplearning4j_tpu.datasets.records import FileSplit as JFileSplit

    rng = np.random.default_rng(2)
    for k in range(3):
        d = tmp_path / "tree" / f"c{k}"
        d.mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8),
                            "RGB").save(d / f"{i}.png")
    _run("etl", 2, tmp_path)
    ranks = [np.load(tmp_path / f"etl_{r}.npz") for r in range(2)]
    files = sorted(str(p) for p in (tmp_path / "tree").rglob("*.png"))
    for r, got in enumerate(ranks):
        assert bool(got["sharded"])
        shard = files[r::2]
        want = [shard[i % len(shard)] for i in range(8)]
        assert got["files"].tolist() == want
        # the reference's shard for the same rank, serial decode
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        it = jetl.ParallelImageDataSetIterator(
            JFileSplit(str(tmp_path / "tree")), 8, 8, 3, batchSize=4,
            numWorkers=2, transport="serial", stallTimeout=30.0)
        try:
            feats, labels = [], []
            while it.hasNext():
                ds = it.next()
                feats.append(np.asarray(ds.getFeatures()))
                labels.append(np.asarray(ds.getLabels()))
        finally:
            it.close()
        assert got["features"].tobytes() == np.stack(feats).tobytes()
        assert got["labels"].tobytes() == np.stack(labels).tobytes()
