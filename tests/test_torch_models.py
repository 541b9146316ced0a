"""``models/pi.py`` and ``models/kmeans.py``: the port against ramba_tpu,
x64 regime (the cases of ``tests/test_models.py``).

``integrate_pi`` must be one flush and agree with ramba_tpu's within
``n * eps`` (the sum's order differs); k-means on separated clusters must
give ramba_tpu's labels exactly and its centroids within ``n * eps`` of
the largest coordinate.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.models.kmeans import kmeans as kmeans_j
from ramba_tpu.models.pi import integrate_pi as integrate_pi_j
from ramba_tpu_torch import common
from ramba_tpu_torch.models.kmeans import kmeans
from ramba_tpu_torch.models.pi import integrate_pi

EPS = 2.0 ** -52


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1000, 100_000, 1_000_000])
def test_pi_value(n):
    got, want = integrate_pi(n), integrate_pi_j(n)
    assert abs(got - want) <= n * EPS * 4
    assert abs(got - np.pi) < 1e-9 if n >= 1_000_000 else True


def test_pi_fully_fused():
    rt.sync()
    before = rt.fuser_stats["flushes"]
    integrate_pi(100_000)
    assert rt.fuser_stats["flushes"] == before + 1


def _clusters(k, per, d, seed):
    rng = np.random.RandomState(seed)
    centres = rng.randn(k, d) * 20
    return np.concatenate([rng.randn(per, d) + c for c in centres]), centres


@pytest.mark.parametrize("k,d", [(2, 2), (4, 3), (8, 5)])
def test_kmeans_matches_reference(k, d):
    pts, _ = _clusters(k, 40, d, seed=k)
    c_got, l_got = kmeans(pts, k=k, iters=6)
    c_want, l_want = kmeans_j(pts, k=k, iters=6)
    assert l_got.dtype == l_want.dtype and c_got.dtype == c_want.dtype
    np.testing.assert_array_equal(l_got, l_want)
    np.testing.assert_allclose(c_got, c_want, rtol=0,
                               atol=len(pts) * EPS * np.abs(pts).max())


def test_kmeans_separated_clusters():
    rng = np.random.RandomState(1)
    a = rng.randn(60, 2) + np.array([10.0, 0.0])
    b = rng.randn(60, 2) + np.array([-10.0, 0.0])
    pts = np.concatenate([a, b])
    cents, labels = kmeans(pts, k=2, iters=8)
    assert len(set(labels[:60])) == 1
    assert len(set(labels[60:])) == 1
    assert labels[0] != labels[60]
    np.testing.assert_allclose(np.sort(cents[:, 0]), [-10.0, 10.0], atol=0.5)


def test_kmeans_takes_a_port_array():
    pts, _ = _clusters(3, 30, 2, seed=9)
    c1, l1 = kmeans(rt.fromarray(pts), k=3, iters=4)
    c2, l2 = kmeans(pts, k=3, iters=4)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(c1, c2)
    assert isinstance(rtj.fromarray(pts), rtj.ndarray)
