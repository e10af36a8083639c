"""One rank of the port's multi-process tests (not a test file).

``tests/test_torch_multihost.py`` starts one process per rank:

    python tests/torch_multihost_worker.py MODE ADDRESS WORLD RANK DIR

Each joins a gloo group through ``MultiHost.initialize`` (every collective
with its timeout), runs MODE and writes what it saw to ``DIR/<mode>_<rank>.npz``
for the parent to compare across ranks and with one process. It imports
neither ``jax`` nor the JAX package: the parent holds the reference.

- ``dp``: two CPU devices a rank; a ShardedTrainer over every rank's
  devices (data = 2 x WORLD) fits the network built from ``DIR/dp_init.npz``
  on ``DIR/dp_data.npz``'s batches (one of them uneven) for 3 epochs; the
  topology, the trained params, the updater state and the score.
- ``ring``: one CPU device a rank, a ``seq`` axis over the ranks; ring
  attention, causal and not, on this rank's block of ``DIR/ring_data.npz``'s
  q, k, v, the output block and the gradients of sum(out * r).
- ``etl``: ``ParallelImageDataSetIterator`` over the PNG tree in
  ``DIR/tree`` with ``shardByHost="auto"``: this rank's files and batches.
"""

import os
import sys

import numpy as np


def _init(addr, world, rank, devices):
    from deeplearning4j_tpu_torch.parallel.multihost import (
        MultiHost, VoidConfiguration)

    return MultiHost.initialize(VoidConfiguration(controllerAddress=addr),
                                num_processes=world, process_id=rank,
                                devices=devices)


def dp(out, world, rank):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import MeshConfig, ShardedTrainer
    from deeplearning4j_tpu_torch.tree_util import tree_leaves
    from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

    init = np.load(os.path.join(out, "dp_init.npz"), allow_pickle=True)
    conf = MultiLayerConfiguration.from_json(str(init["conf"]))
    arrays = init["arrays"].tolist()
    net = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))
    mesh = MeshConfig.data_parallel(devices=["cpu", "cpu"])
    data = np.load(os.path.join(out, "dp_data.npz"))
    batches = [DataSet(data[f"x{i}"], data[f"y{i}"])
               for i in range(int(data["n"]))]
    ShardedTrainer(net, mesh).fit(batches, epochs=3)
    np.savez(os.path.join(out, f"dp_{rank}.npz"),
             mesh=np.asarray([mesh.shape["data"], mesh.rank,
                              mesh.coords("data")[0],
                              mesh.coords("data")[-1]]),
             params=net.params().numpy(),
             opt=np.concatenate([t.reshape(-1).numpy() for t in
                                 tree_leaves(net._opt_states)] + [[]]),
             score=np.float64(net._score), iteration=net._iteration)


def ring(out, world, rank):
    import torch

    from deeplearning4j_tpu_torch.parallel import MeshConfig, ring_attention
    from deeplearning4j_tpu_torch.parallel.mesh import global_batch

    mesh = MeshConfig(data=1, seq=world, devices=["cpu"]).build()
    data = np.load(os.path.join(out, "ring_data.npz"))
    spec = (None, None, "seq", None)
    saved = {}
    for causal in (False, True):
        q, k, v = (global_batch(mesh, data[n], spec).clone().requires_grad_()
                   for n in ("q", "k", "v"))
        r = global_batch(mesh, data["r"], spec)
        o = ring_attention(q, k, v, mesh, causal=causal)
        gq, gk, gv = torch.autograd.grad((o * r).sum(), (q, k, v))
        tag = "causal" if causal else "full"
        for name, t in (("o", o), ("dq", gq), ("dk", gk), ("dv", gv)):
            saved[f"{tag}_{name}"] = t.detach().numpy()
    np.savez(os.path.join(out, f"ring_{rank}.npz"), **saved)


def etl(out, world, rank):
    from deeplearning4j_tpu_torch.datasets import (
        FileSplit, ParallelImageDataSetIterator)

    it = ParallelImageDataSetIterator(
        FileSplit(os.path.join(out, "tree")), 8, 8, 3, batchSize=4,
        numWorkers=2, transport="serial", stallTimeout=30.0)
    try:
        feats, labels = [], []
        while it.hasNext():
            ds = it.next()
            feats.append(np.asarray(ds.getFeatures()))
            labels.append(np.asarray(ds.getLabels()))
        np.savez(os.path.join(out, f"etl_{rank}.npz"),
                 files=np.asarray(it._files), sharded=it.hostSharded,
                 features=np.stack(feats), labels=np.stack(labels))
    finally:
        it.close()


def main():
    mode, addr, world, rank, out = sys.argv[1:6]
    world, rank = int(world), int(rank)
    import torch

    torch.set_num_threads(1)
    devices = ["cpu", "cpu"] if mode == "dp" else ["cpu"]
    topo = _init(addr, world, rank, devices)
    print("TOPOLOGY", topo["process_index"], topo["process_count"],
          topo["local_devices"], topo["global_devices"], flush=True)
    from deeplearning4j_tpu_torch.parallel.multihost import MultiHost

    try:
        {"dp": dp, "ring": ring, "etl": etl}[mode](out, world, rank)
    finally:
        MultiHost.shutdown()
    print("DONE", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
