"""The port's clustering and graph packages (``deeplearning4j_tpu_torch/
clustering``, ``graph``) against the JAX package's, on the CPU.

- Bitwise: DeepWalk's random walks; the VPTree (its nodes and radii, and
  every search's indices and distances, euclidean and cosine); the k-NN
  server's answers, over HTTP, against the reference server's ``query``.
- k-means from the same first centers (the same numpy draw): assignments
  equal, centers within ``KMEANS_TOL`` of the largest coordinate; one
  Lloyd step from given centers likewise.
- t-SNE: the pairwise distances and ``_binary_search_betas`` within
  ``P_TOL`` of the largest element; the gradient descent from the
  reference's own ``y0`` within ``TSNE_TOL`` of the largest coordinate
  over ``TSNE_SHORT`` iterations. Over longer runs the early-exaggeration
  phase amplifies float32 rounding (a difference of 1e-7 grows about
  2.3x an iteration and reaches percents by iteration 10-20 on these
  inputs), so a 300-iteration run is held by its KL(P || Q) instead, within
  ``KL_TOL`` relative.
- ``tests/test_domain.py``'s DeepWalk, VPTree, KMeans, t-SNE and server
  cases run on the port with ``device="cpu"``.
- Entry points raise without CUDA; ``cuda``-marked cases hold the card
  against the CPU and skip here.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.clustering import (
    BarnesHutTsne as JTsne, KMeansClustering as JKMeans,
    NearestNeighborsServer as JServer, VPTree as JVPTree)
from deeplearning4j_tpu.clustering import tsne as jtsne
from deeplearning4j_tpu.graph import (
    Graph as JGraph, RandomWalkIterator as JWalks)
from deeplearning4j_tpu_torch.clustering import (
    BarnesHutTsne, KMeansClustering, NearestNeighborsServer, VPTree)
from deeplearning4j_tpu_torch.clustering import kmeans as pkmeans
from deeplearning4j_tpu_torch.clustering import tsne as ptsne
from deeplearning4j_tpu_torch.graph import DeepWalk, Graph, RandomWalkIterator
from deeplearning4j_tpu_torch.utils.convert import embeddings_from_numpy

KMEANS_TOL = 1e-5
P_TOL = 1e-5
TSNE_SHORT = 3
TSNE_TOL = 1e-4
KL_TOL = 0.05


# -- DeepWalk ------------------------------------------------------------------

def _graphs(cls):
    cliques = cls(12)
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                cliques.addEdge(base + i, base + j)
    cliques.addEdge(0, 6)
    rng = np.random.default_rng(4)
    directed = cls(20, directed=True)
    for a, b in rng.integers(0, 20, (50, 2)):
        directed.addEdge(int(a), int(b))
    lonely = cls(5)
    lonely.addEdge(0, 1)
    lonely.addEdge(1, 2)           # 3 and 4 have no edge
    return [cliques, directed, lonely]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("length,per_vertex,seed", [(10, 8, 1), (1, 2, 0),
                                                    (7, 3, 9)])
def test_walks_bitwise(which, length, per_vertex, seed):
    g, jg = _graphs(Graph)[which], _graphs(JGraph)[which]
    assert g.adj == jg.adj and g.numVertices() == jg.numVertices()
    got = list(RandomWalkIterator(g, length, seed, per_vertex).walks())
    want = list(JWalks(jg, length, seed, per_vertex).walks())
    assert got == want
    assert all(type(v) is int for walk in got for v in walk)


def test_deepwalk_trains_the_port_word2vec_on_the_walks():
    g = _graphs(Graph)[1]
    dw = (DeepWalk.Builder().vectorSize(8).windowSize(2).epochs(1)
          .walkLength(5).walksPerVertex(2).seed(3).build())
    dw.fit(g, device="cpu")
    w2v = dw._w2v
    assert w2v.device.type == "cpu" and w2v.syn0.device.type == "cpu"
    want = [" ".join(str(v) for v in walk) for walk in
            JWalks(_graphs(JGraph)[1], 5, 3, 2).walks()]
    assert w2v.sentences._sentences == want
    assert w2v.cfg["sampling"] == 0 and w2v.cfg["minWordFrequency"] == 1
    assert dw.getVertexVector(0).shape == (8,)


# -- VPTree --------------------------------------------------------------------

def _nodes(node):
    if node is None:
        return []
    return [(node.index, node.radius)] + _nodes(node.inside) + \
        _nodes(node.outside)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,dim,seed", [(200, 8, 0), (57, 3, 1), (1, 4, 2),
                                        (300, 16, 3)])
def test_vptree_bitwise(distance, n, dim, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, dim))
    pts[n // 2] = pts[0]                 # a duplicate point
    got, want = VPTree(pts, distance, seed), JVPTree(pts, distance, seed)
    assert _nodes(got.root) == _nodes(want.root)
    for k in (1, 5, n + 2):
        for q in rng.normal(size=(4, dim)):
            assert got.search(q, k) == want.search(q, k)


# -- k-means -------------------------------------------------------------------

def _blobs(seed=0, n=400, dim=6, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (k, dim))
    return (centers[rng.integers(0, k, n)]
            + rng.normal(0, 1, (n, dim))).astype(np.float32)


@pytest.mark.parametrize("k,seed,iters", [(4, 0, 100), (7, 3, 100),
                                          (3, 1, 2), (12, 5, 100)])
def test_kmeans_from_the_same_centers(k, seed, iters):
    pts = _blobs(seed)
    want = JKMeans.setup(k, iters, seed=seed)
    got = KMeansClustering.setup(k, iters, seed=seed, device="cpu")
    a, b = want.applyTo(pts), got.applyTo(pts)
    assert b.dtype == a.dtype and np.array_equal(a, b)
    scale = np.abs(want.centers).max()
    assert np.abs(got.centers - want.centers).max() <= KMEANS_TOL * scale


def test_one_lloyd_step_equals_the_reference_step():
    # the reference's applyTo with one iteration starts from its numpy
    # draw of centers: the same draw starts the port's step
    pts = _blobs(2)
    ref = JKMeans(5, maxIterations=1, seed=8)
    want_assign = ref.applyTo(pts)
    centers = pts[np.random.default_rng(8).choice(len(pts), 5,
                                                   replace=False)]
    new, assign = pkmeans.lloyd_step(torch.tensor(pts),
                                     torch.tensor(centers))
    assert np.array_equal(assign.to(torch.int32).numpy(), want_assign)
    assert np.abs(new.numpy() - ref.centers).max() <= \
        KMEANS_TOL * np.abs(ref.centers).max()


def test_an_empty_cluster_keeps_its_center():
    pts = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]])
    centers = torch.tensor([[0.0, 0.0], [5.0, 5.0], [1e3, 1e3]])
    new, assign = pkmeans.lloyd_step(pts, centers)
    assert assign.tolist() == [0, 0, 1]
    assert new.tolist() == [[0.05000000074505806, 0.0], [5.0, 5.0],
                            [1e3, 1e3]]


def test_kmeans_state_is_carried():
    km = KMeansClustering(3, device="cpu")
    embeddings_from_numpy(km, {"centers": np.ones((3, 2))})
    assert km.centers.dtype == np.float32 and km.centers.shape == (3, 2)
    with pytest.raises(ValueError, match="centers"):
        embeddings_from_numpy(km, {"centers": np.ones((2, 2))})


# -- t-SNE ---------------------------------------------------------------------

def _two_clusters(n=30, dim=10, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(n, dim), rng.randn(n, dim) + 8.0]) \
        .astype(np.float32)


def _kl(p, y):
    y = np.asarray(y, np.float64)
    d = ((y[:, None] - y[None]) ** 2).sum(-1)
    num = 1.0 / (1.0 + d)
    np.fill_diagonal(num, 0.0)
    q = num / num.sum()
    p = np.asarray(p, np.float64)
    off = ~np.eye(len(y), dtype=bool)
    return float((p[off] * np.log(p[off] / np.maximum(q[off], 1e-12))).sum())


@pytest.mark.parametrize("perplexity", [5.0, 10.0, 30.0])
def test_affinities_equal_the_reference(perplexity):
    x = _two_clusters()
    dj = jtsne._pairwise_sq_dists(jnp.asarray(x))
    dp = ptsne._pairwise_sq_dists(torch.tensor(x))
    assert np.abs(dp.numpy() - np.asarray(dj)).max() <= \
        P_TOL * np.abs(np.asarray(dj)).max()
    pj = np.asarray(jtsne._binary_search_betas(dj, perplexity))
    pp = ptsne._binary_search_betas(torch.tensor(np.asarray(dj)),
                                    perplexity).numpy()
    assert np.abs(pp - pj).max() <= P_TOL * pj.max()
    np.testing.assert_allclose(pp.sum(1), 1.0, rtol=1e-5)


def _reference_y0(seed, n, dim):
    return np.asarray(1e-4 * jax.random.normal(jax.random.key(seed),
                                               (n, dim)))


@pytest.mark.parametrize("dim,lr", [(2, 100.0), (3, 200.0)])
def test_short_tsne_from_the_reference_y0(dim, lr):
    x = _two_clusters()
    want = JTsne(numDimension=dim, perplexity=10.0, learningRate=lr,
                 maxIter=TSNE_SHORT).fit(x).getData()
    got = BarnesHutTsne(numDimension=dim, perplexity=10.0, learningRate=lr,
                        maxIter=TSNE_SHORT, device="cpu")
    y = got._optimize(got._affinities(x),
                      torch.tensor(_reference_y0(42, 60, dim))).numpy()
    assert np.abs(y - want).max() <= TSNE_TOL * np.abs(want).max()


def test_long_tsne_reaches_the_reference_kl():
    x = _two_clusters()
    want = JTsne(perplexity=10.0, learningRate=100.0, maxIter=300,
                 usePca=True).fit(x).getData()
    got = BarnesHutTsne(perplexity=10.0, learningRate=100.0, maxIter=300,
                        usePca=True, device="cpu")
    p = got._affinities(x)
    y = got._optimize(p, torch.tensor(_reference_y0(42, 60, 2))).numpy()
    kl_got, kl_want = _kl(p.numpy(), y), _kl(p.numpy(), want)
    assert abs(kl_got - kl_want) <= KL_TOL * kl_want, (kl_got, kl_want)


def test_tsne_fit_draws_y0_from_its_seed():
    x = _two_clusters(10, 4)
    a = BarnesHutTsne(maxIter=5, seed=3, device="cpu").fit(x).getData()
    b = BarnesHutTsne(maxIter=5, seed=3, device="cpu").fit(x).getData()
    c = BarnesHutTsne(maxIter=5, seed=4, device="cpu").fit(x).getData()
    assert a.tobytes() == b.tobytes() and a.tobytes() != c.tobytes()
    assert a.dtype == np.float32 and a.shape == (20, 2)


# -- the k-NN server -----------------------------------------------------------

def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_server_answers_equal_the_reference_over_http():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(100, 5)).astype(np.float32)
    labels = [f"p{i}" for i in range(100)]
    ref = JServer(pts, labels=labels, distance="cosine")
    srv = NearestNeighborsServer(pts, labels=labels,
                                 distance="cosine").start(port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/status", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok",
                                            "numPoints": 100, "dim": 5}
        for path in ("/knn", "/knnnew"):
            for q in rng.normal(size=(3, 5)):
                got = _post(base, path, json.dumps(
                    {"ndarray": q.tolist(), "k": 4}).encode())
                assert got == {"results": ref.query(
                    np.asarray(q, np.float32), 4)}
        for path, payload, code in (("/knn", b"notjson", 400),
                                    ("/nope", b"{}", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, path, payload)
            assert e.value.code == code
    finally:
        srv.stop()
    assert srv._httpd is None and srv._thread is None


# -- tests/test_domain.py's cases on the port ----------------------------------

class TestPortDeepWalk:
    def test_two_cliques_embed_apart(self):
        g = _graphs(Graph)[0]
        dw = (DeepWalk.Builder().vectorSize(16).windowSize(3)
              .learningRate(0.02).epochs(5).walkLength(10)
              .walksPerVertex(8).seed(1).build())
        dw.fit(g, device="cpu")
        within = dw.similarity(1, 2)
        across = dw.similarity(1, 8)
        assert within > across, (within, across)
        near = dw.verticesNearest(1, 4)
        assert sum(1 for v in near if v < 6) >= 3, near


class TestPortVPTree:
    def test_exact_vs_bruteforce(self):
        rng = np.random.default_rng(0)
        pts = rng.normal(size=(200, 8))
        tree = VPTree(pts)
        q = rng.normal(size=8)
        idxs, dists = tree.search(q, 5)
        brute = np.argsort(np.linalg.norm(pts - q, axis=1))[:5]
        assert set(idxs) == set(brute.tolist())
        assert dists == sorted(dists)

    def test_cosine_distance(self):
        pts = np.array([[1, 0], [0, 1], [1, 0.1], [-1, 0]], np.float64)
        tree = VPTree(pts, distance="cosine")
        idxs, _ = tree.search(np.array([1.0, 0.0]), 2)
        assert set(idxs) == {0, 2}

    def test_single_point(self):
        tree = VPTree(np.zeros((1, 3)))
        idxs, dists = tree.search(np.ones(3), 1)
        assert idxs == [0]


class TestPortKMeans:
    def test_separated_clusters(self):
        rng = np.random.default_rng(0)
        a = rng.normal(0, 0.3, (50, 2))
        b = rng.normal(5, 0.3, (50, 2))
        assign = KMeansClustering.setup(2, seed=3, device="cpu").applyTo(
            np.concatenate([a, b]))
        assert len(set(assign[:50].tolist())) == 1
        assert len(set(assign[50:].tolist())) == 1
        assert assign[0] != assign[50]


class TestPortTsne:
    def test_separates_two_clusters(self, tmp_path):
        x = _two_clusters()
        tsne = (BarnesHutTsne.Builder()
                .numDimension(2).perplexity(10.0)
                .learningRate(100.0).setMaxIter(300).build(device="cpu"))
        tsne.fit(x)
        emb = tsne.getData()
        assert emb.shape == (60, 2)
        ca, cb = emb[:30].mean(0), emb[30:].mean(0)
        spread = (emb[:30].std() + emb[30:].std()) / 2
        assert np.linalg.norm(ca - cb) > 2.0 * spread
        p = str(tmp_path / "tsne.txt")
        tsne.saveAsFile([str(i // 30) for i in range(60)], p)
        lines = open(p).read().strip().splitlines()
        assert len(lines) == 60 and lines[0].endswith(" 0")

    def test_builder_rejects_typos(self):
        with pytest.raises(AttributeError, match="perplexityy"):
            BarnesHutTsne.Builder().perplexityy(5.0)

    def test_get_data_before_fit_raises(self):
        with pytest.raises(RuntimeError, match="fit"):
            BarnesHutTsne(device="cpu").getData()


class TestPortNearestNeighborsServer:
    def test_knn_over_http(self):
        pts = np.asarray([[0, 0], [1, 0], [5, 5], [5, 6]], np.float32)
        srv = NearestNeighborsServer(pts, labels=["a", "b", "c", "d"])
        srv.start(port=0)
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(base + "/status", timeout=30) as r:
                st = json.loads(r.read())
            assert st["numPoints"] == 4 and st["dim"] == 2
            res = _post(base, "/knn", json.dumps(
                {"ndarray": [5.0, 5.2], "k": 2}).encode())["results"]
            assert [x["label"] for x in res] == ["c", "d"]
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, "/knn", b"notjson")
            assert e.value.code == 400
        finally:
            srv.stop()


# -- the device rule -----------------------------------------------------------

def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: KMeansClustering(2),
                 lambda: KMeansClustering.setup(2),
                 lambda: BarnesHutTsne(),
                 lambda: BarnesHutTsne.Builder().maxIter(5).build(),
                 lambda: DeepWalk.Builder().build().fit(_graphs(Graph)[2])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert KMeansClustering(2, device="cpu").device.type == "cpu"


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_lloyd_steps_on_the_card_equal_the_cpu(cuda):
    pts = _blobs(0, 5000, 32, 10)
    centers = torch.tensor(pts[:10])
    x_gpu, x_cpu = torch.tensor(pts, device=cuda), torch.tensor(pts)
    for _ in range(5):
        new_gpu, a_gpu = pkmeans.lloyd_step(x_gpu, centers.to(cuda))
        new_cpu, a_cpu = pkmeans.lloyd_step(x_cpu, centers)
        assert torch.equal(a_gpu.cpu(), a_cpu)
        assert (new_gpu.cpu() - new_cpu).abs().max() <= \
            KMEANS_TOL * new_cpu.abs().max()
        centers = new_cpu
    km = KMeansClustering(10, device=cuda)
    assert km.applyTo(pts).shape == (5000,)


@pytest.mark.cuda
def test_tsne_on_the_card_equals_the_cpu_early(cuda):
    x = _two_clusters(100, 32)
    y0 = 1e-4 * torch.randn((200, 2), generator=torch.Generator()
                            .manual_seed(0))
    ys = []
    for dev in (cuda, "cpu"):
        t = BarnesHutTsne(perplexity=20.0, device=dev)
        ys.append(t._optimize(t._affinities(x), y0.to(dev), 5).cpu())
    assert (ys[0] - ys[1]).abs().max() <= 1e-3 * ys[1].abs().max()
