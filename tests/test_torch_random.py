"""``ramba_tpu_torch.random`` against ``ramba_tpu.random``, x64 regime.

The two packages cannot draw equal values (threefry there, torch's
generators here), so the parity is of shape, dtype, support and
distribution:

* every function gives ramba_tpu's shape and dtype for ``size`` None, an
  int and a tuple;
* supports hold (randint in [lo, hi), a permutation is one, ``choice``
  without replacement gives distinct values);
* each continuous draw passes ``scipy.stats.kstest`` against its
  distribution and each discrete one a chi-square test (bins with an
  expected count under 5 merged), at n = 2^16 with fixed seeds and
  p > 1e-3; ramba_tpu's draws pass the same test, so the test is fair;
* within the port: reseeding reproduces every draw, a RandomState leaves
  the global stream alone, re-running one draw's program gives the same
  bytes, and ten seeds of one shape add no compile.

Mirrors ``tests/test_distributed_array.py:636-665`` and
``tests/test_numpy_breadth.py:660-700``.
"""

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common
from ramba_tpu_torch.core import fuser

N = 1 << 16
P_MIN = 1e-3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


# name -> call(module, size)
DRAWS = {
    "random": lambda m, s: m.random.random(s),
    "random_sample": lambda m, s: m.random.random_sample(s),
    "sample": lambda m, s: m.random.sample(s),
    "normal": lambda m, s: m.random.normal(1.0, 2.0, size=s),
    "uniform": lambda m, s: m.random.uniform(2.0, 5.0, size=s),
    "randint": lambda m, s: m.random.randint(3, 11, size=s),
    "randint_int32": lambda m, s: m.random.randint(-4, 4, size=s,
                                                   dtype=np.int32),
    "standard_normal": lambda m, s: m.random.standard_normal(s),
    "exponential": lambda m, s: m.random.exponential(2.0, size=s),
    "poisson": lambda m, s: m.random.poisson(3.0, size=s),
    "beta": lambda m, s: m.random.beta(2.0, 3.0, size=s),
    "gamma": lambda m, s: m.random.gamma(2.5, 1.5, size=s),
    "binomial": lambda m, s: m.random.binomial(10, 0.3, size=s),
    "choice": lambda m, s: m.random.choice(5, size=s),
    "choice_p": lambda m, s: m.random.choice(4, size=s,
                                             p=[0.1, 0.2, 0.3, 0.4]),
    "rs_random": lambda m, s: m.random.RandomState(3).random(s),
    "rs_normal": lambda m, s: m.random.RandomState(3).normal(2.0, 0.5, s),
    "default_rng": lambda m, s: m.random.default_rng(4).random(s),
}


@pytest.mark.parametrize("size", [None, 7, (3, 4)])
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_shape_and_dtype_match_reference(name, size):
    got = np.asarray(DRAWS[name](rt, size).asarray())
    want = np.asarray(DRAWS[name](rtj, size).asarray())
    assert got.shape == want.shape
    assert got.dtype == want.dtype


@pytest.mark.parametrize("size", [None, 3, (2, 3)])
def test_rand_randn_and_choice_norepl_shapes(size):
    shape = () if size is None else ((size,) if isinstance(size, int)
                                     else size)
    for call in (lambda m: m.random.rand(*shape),
                 lambda m: m.random.randn(*shape),
                 lambda m: m.random.choice(16, size=size, replace=False)):
        got, want = call(rt).asarray(), call(rtj).asarray()
        assert np.shape(got) == np.shape(want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


def _ks(name, v):
    dists = {
        "random": ("uniform", ()), "normal": ("norm", (1.0, 2.0)),
        "uniform": ("uniform", (2.0, 3.0)),
        "standard_normal": ("norm", ()),
        "exponential": ("expon", (0.0, 2.0)),
        "beta": ("beta", (2.0, 3.0)), "gamma": ("gamma", (2.5, 0.0, 1.5)),
    }
    dist, args = dists[name]
    return stats.kstest(v, dist, args=args).pvalue


def _chi2(v, pmf):
    """Chi-square p-value of integer draws ``v`` against ``pmf`` (a dict
    value -> probability), merging bins expected under 5 counts."""
    keys = sorted(pmf)
    obs = np.array([np.sum(v == k) for k in keys], float)
    exp = np.array([pmf[k] for k in keys]) * len(v)
    # the tail beyond the listed values joins the last bin
    obs[-1] += len(v) - obs.sum()
    exp[-1] += len(v) - exp.sum()
    o, e = [], []
    acc_o = acc_e = 0.0
    for oi, ei in zip(obs, exp):
        acc_o, acc_e = acc_o + oi, acc_e + ei
        if acc_e >= 5:
            o.append(acc_o)
            e.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e:
        o[-1] += acc_o
        e[-1] += acc_e
    return stats.chisquare(o, e).pvalue


CONTINUOUS = ["random", "normal", "uniform", "standard_normal",
              "exponential", "beta", "gamma"]
DISCRETE = {
    "randint": {k: 1 / 8 for k in range(3, 11)},
    "poisson": {k: stats.poisson.pmf(k, 3.0) for k in range(0, 15)},
    "binomial": {k: stats.binom.pmf(k, 10, 0.3) for k in range(0, 11)},
    "choice": {k: 0.2 for k in range(5)},
    "choice_p": {0: 0.1, 1: 0.2, 2: 0.3, 3: 0.4},
}


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("name", CONTINUOUS)
def test_continuous_distribution(name, pkg):
    m = rt if pkg == "port" else rtj
    m.random.seed(2024)
    v = np.asarray(DRAWS[name](m, N).asarray())
    assert _ks(name, v) > P_MIN


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("name", sorted(DISCRETE))
def test_discrete_distribution(name, pkg):
    m = rt if pkg == "port" else rtj
    m.random.seed(77)
    v = np.asarray(DRAWS[name](m, N).asarray())
    assert set(np.unique(v)) <= set(range(0, 64))
    assert _chi2(v, DISCRETE[name]) > P_MIN


def test_randint_support():
    rt.random.seed(5)
    v = rt.random.randint(5, 15, size=N).asarray()
    assert v.min() == 5 and v.max() == 14
    w = rt.random.randint(7, size=1000).asarray()
    assert w.min() >= 0 and w.max() < 7
    with pytest.raises(ValueError):
        rt.random.randint(4, 4, size=3)


def test_permutation_and_shuffle():
    perm = rt.random.permutation(257).asarray()
    assert sorted(perm) == list(range(257))
    assert perm.dtype == np.int64 == rtj.random.permutation(5).asarray().dtype
    arr = rt.fromarray(np.arange(100.0))
    pa = rt.random.permutation(arr).asarray()
    assert sorted(pa) == list(range(100)) and pa.dtype == np.float64
    m = rt.fromarray(np.arange(12).reshape(4, 3))
    pm = rt.random.permutation(m).asarray()
    assert sorted(pm[:, 0]) == [0, 3, 6, 9]
    np.testing.assert_array_equal(pm[:, 1] - pm[:, 0], 1)
    x = rt.fromarray(np.arange(64.0))
    rt.random.shuffle(x)
    got = x.asarray()
    assert sorted(got) == list(range(64))
    assert not (got == np.arange(64.0)).all()


def test_choice():
    c = rt.random.choice(5, size=1000).asarray()
    assert set(np.unique(c)) <= set(range(5))
    cn = rt.random.choice(16, size=16, replace=False).asarray()
    assert sorted(cn) == list(range(16))
    cnp = rt.random.choice(50, size=20, replace=False,
                           p=np.arange(50) + 1.0).asarray()
    assert len(set(cnp)) == 20
    cp = rt.random.choice(3, size=5000, p=[0.1, 0.1, 0.8]).asarray()
    assert (cp == 2).mean() > 0.7
    vals = np.array([10.0, 20.0, 30.0])
    cv = rt.random.choice(rt.fromarray(vals), size=100).asarray()
    assert set(np.unique(cv)) <= {10.0, 20.0, 30.0}
    with pytest.raises(ValueError, match="larger sample"):
        rt.random.choice(3, size=4, replace=False)


def test_moments_and_array_scale():
    rt.random.seed(0)
    a = rt.random.normal(loc=3.0, scale=2.0, size=200_000)
    assert float(a.mean()) == pytest.approx(3.0, abs=0.05)
    assert float(a.std()) == pytest.approx(2.0, abs=0.05)
    scales = np.array([1.0, 2.0, 3.0, 4.0])
    e = rt.random.exponential(scales, size=4).asarray()
    assert e.shape == (4,) and (e >= 0).all()
    g = rt.random.gamma(3.0, scales, size=4).asarray()
    assert g.shape == (4,) and (g > 0).all()


def _all_draws(size=32):
    return [np.asarray(DRAWS[n](rt, size).asarray()) for n in sorted(DRAWS)] \
        + [rt.random.permutation(40).asarray(),
           rt.random.choice(9, size=5, replace=False).asarray()]


def test_seed_reproduces_every_draw():
    rt.random.seed(42)
    a = _all_draws()
    rt.random.seed(42)
    b = _all_draws()
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    rt.random.seed(43)
    c = _all_draws()
    assert any(x.tobytes() != y.tobytes() for x, y in zip(a, c))
    d1 = rt.random.random(8).asarray()
    d2 = rt.random.random(8).asarray()
    assert d1.tobytes() != d2.tobytes()  # the stream moves on


def test_random_state_leaves_the_global_stream_alone():
    rt.random.seed(5)
    a = rt.random.random(100).asarray()
    rt.random.seed(5)
    rs = rt.random.RandomState(9)
    rs.random(100).asarray()
    rs.normal(size=10).asarray()
    b = rt.random.random(100).asarray()
    assert a.tobytes() == b.tobytes()
    r1 = rt.random.RandomState(7).random(50).asarray()
    r2 = rt.random.default_rng(7).random(50).asarray()
    assert r1.tobytes() == r2.tobytes()


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_rerun_of_one_program_is_byte_equal(name):
    rt.random.seed(11)
    x = DRAWS[name](rt, (5, 6))
    expr = x.read_expr()
    v1, v2 = fuser.evaluate(expr), fuser.evaluate(expr)
    assert v1.dtype == v2.dtype
    assert v1.numpy().tobytes() == v2.numpy().tobytes()


def test_new_seeds_add_no_compile():
    rt.random.seed(0)
    rt.random.normal(size=(33, 5)).asarray()
    rt.random.randint(0, 9, size=77).asarray()
    c0 = rt.fuser_stats["compiles"]
    for s in range(10):
        rt.random.seed(s)
        rt.random.normal(size=(33, 5)).asarray()
        rt.random.randint(0, 9, size=77).asarray()
    assert rt.fuser_stats["compiles"] == c0


def test_key_is_a_host_leaf_not_static():
    x = rt.random.random(10)
    node = x.read_expr()
    kind, shape, dtype, spec = node.static
    assert (kind, shape, dtype, spec) == ("uniform", (10,), "float64", None)
    key = node.args[0].value
    assert key.device.type == "cpu" and key.dtype == torch.int64
    assert key.dim() == 0 and int(key) >= 0


def test_default_rng_reference_surface():
    v = rt.random.default_rng(7).random(100).asarray()
    assert v.shape == (100,) and ((v >= 0) & (v < 1)).all()
    a = rt.random.random((100, 4))
    assert a.shape == (100, 4)
    w = a.asarray()
    assert ((w >= 0) & (w < 1)).all()


def test_draws_land_on_the_port_device():
    x = rt.random.random(16)
    assert x._value().device == common.device()
