"""The NumPy protocol on port arrays: ``__array_function__`` and
``__array_ufunc__``, against ramba_tpu, x64 regime.

``numpy.<fn>`` of port arrays must run the port's function and return a
port array (nothing silently computed on the host), exactly as
``numpy.<fn>`` of ramba_tpu arrays returns a ramba_tpu array; a NumPy
function the port has not registered raises ``TypeError``.  Values and
dtypes are compared exactly, except float sums within rtol=atol=1e-12
(float64: torch and XLA sum in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.core import interop


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray()
                                         for k, a in ref.items()})
    return ref, port


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in _flat(x)]
    return [out]


RS = np.random.RandomState(0)
DATA = {"x": np.round(RS.randn(12) * 5, 2), "X": np.round(RS.randn(3, 4) * 5, 2),
        "i": RS.randint(-9, 9, 12).astype(np.int32)}

# NumPy functions and one call of each on the arrays above
CALLS = {
    "concatenate": lambda a: np.concatenate([a["x"], a["x"][:3]]),
    "stack": lambda a: np.stack([a["x"], a["i"]]),
    "vstack": lambda a: np.vstack([a["X"], a["X"]]),
    "hstack": lambda a: np.hstack([a["x"], a["i"]]),
    "where": lambda a: np.where(a["x"] > 0, a["x"], -1.0),
    "sort": lambda a: np.sort(a["X"], axis=0),
    "argsort": lambda a: np.argsort(a["x"]),
    "dot": lambda a: np.dot(a["X"], a["X"].T),
    "matmul": lambda a: np.matmul(a["X"].T, a["X"]),
    "transpose": lambda a: np.transpose(a["X"]),
    "reshape": lambda a: np.reshape(a["x"], (3, 4)),
    "ravel": lambda a: np.ravel(a["X"]),
    "flip": lambda a: np.flip(a["X"], 1),
    "roll": lambda a: np.roll(a["x"], 2),
    "pad": lambda a: np.pad(a["X"], 1),
    "tile": lambda a: np.tile(a["i"], 2),
    "repeat": lambda a: np.repeat(a["i"], 2),
    "take": lambda a: np.take(a["x"], np.array([0, 3, 20])),
    "tril": lambda a: np.tril(a["X"]),
    "moveaxis": lambda a: np.moveaxis(a["X"], 0, 1),
    "expand_dims": lambda a: np.expand_dims(a["x"], 0),
    "squeeze": lambda a: np.squeeze(a["X"][:1]),
    "clip": lambda a: np.clip(a["x"], -1, 1),
    "sum": lambda a: np.sum(a["X"], axis=1),
    "mean": lambda a: np.mean(a["X"]),
    "cumsum": lambda a: np.cumsum(a["i"]),
    "outer": lambda a: np.outer(a["i"][:3], a["i"][:4]),
    "einsum": lambda a: np.einsum("ij->j", a["X"]),
    "trace": lambda a: np.trace(a["X"]),
    "zeros_like": lambda a: np.zeros_like(a["X"]),
    "split": lambda a: np.split(a["x"], 3),
}
SUMS = ("dot", "matmul", "sum", "mean", "einsum", "trace")


@pytest.mark.parametrize("name", sorted(CALLS))
def test_numpy_functions_return_port_arrays(name):
    ref, port = _pair(**DATA)
    want = _flat(CALLS[name](ref))
    got = _flat(CALLS[name](port))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(w, rtj.ndarray), f"{name}: ramba_tpu gave {type(w)}"
        assert isinstance(g, rt.ndarray), f"{name}: the port gave {type(g)}"
        gv, wv = g.asarray(), w.asarray()
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        if name in SUMS and wv.dtype.kind == "f":
            np.testing.assert_allclose(gv, wv, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(gv, wv)


# (np.fft.fft, np.unique, np.gradient, np.linalg.norm and np.histogram
# stood here until the port registered them, as ramba_tpu does)
@pytest.mark.parametrize("fn", [np.histogram_bin_edges, np.sinc, np.i0,
                                np.linalg.matrix_norm, np.meshgrid])
def test_unregistered_functions_raise(fn):
    """Neither a host copy nor a numpy.ndarray: NumPy raises TypeError."""
    with pytest.raises(TypeError):
        fn(rt.arange(8.0))


def test_registry_holds_only_port_functions():
    for np_fn, ours in interop.HANDLED_FUNCTIONS.items():
        assert ours.__module__.startswith("ramba_tpu_torch"), np_fn
    assert np.concatenate in interop.HANDLED_FUNCTIONS
    assert np.unique in interop.HANDLED_FUNCTIONS  # a host boundary, as there
    assert np.histogram_bin_edges not in interop.HANDLED_FUNCTIONS


def test_metadata_functions_stay_on_the_host():
    a = rt.zeros((3, 4))
    assert np.shape(a) == (3, 4) and np.ndim(a) == 2 and np.size(a) == 12
    assert rt.shape([[1, 2]]) == (1, 2) and rt.size(a, 1) == 4


UFUNC_CALLS = {
    "add_reduce": lambda m, a: np.add.reduce(a["X"], axis=1),
    "maximum_reduce": lambda m, a: np.maximum.reduce(a["X"]),
    "logical_or_reduce": lambda m, a: np.logical_or.reduce(a["X"] > 0, axis=0),
    "multiply_reduce_dtype": lambda m, a: np.multiply.reduce(a["i"], dtype=np.float64),
    "matmul_numpy_left": lambda m, a: np.ones((2, 3)) @ a["X"],
    "matmul_ufunc": lambda m, a: np.matmul(np.ones((2, 3)), a["X"]),
    "binary": lambda m, a: np.hypot(a["x"], 2.0),
    "out_port": lambda m, a: _out_port(m, a),
}


def _out_port(m, a):
    o = m.zeros(12, dtype=np.int32)
    np.add(a["x"], 1.0, out=o)
    return o


@pytest.mark.parametrize("name", sorted(UFUNC_CALLS))
def test_ufunc_protocol(name):
    ref, port = _pair(**DATA)
    want = UFUNC_CALLS[name](rtj, ref)
    got = UFUNC_CALLS[name](rt, port)
    assert isinstance(got, rt.ndarray)
    gv, wv = got.asarray(), want.asarray()
    assert gv.dtype == wv.dtype and gv.shape == wv.shape
    np.testing.assert_allclose(gv, wv, rtol=1e-12, atol=1e-12)


def test_ufunc_out_numpy_and_where():
    x = rt.fromarray(DATA["x"])
    o = np.zeros(12)
    np.add(x, 1.0, out=o)
    np.testing.assert_array_equal(o, DATA["x"] + 1.0)
    o_int = np.zeros(12, np.int64)
    with pytest.raises(TypeError):  # float into int: same_kind refuses
        np.add(x, 1.0, out=o_int)
    with pytest.raises(TypeError):  # where= is not taken
        np.add(x, 1.0, where=np.ones(12, bool))


def test_isscalar_result_type_implements():
    assert rt.isscalar(rt.sum(rt.arange(3))) and not rt.isscalar(rt.arange(3))
    assert rt.isscalar(2.0) and not rt.isscalar([1])
    assert rt.result_type(rt.arange(3), np.float32) == np.float64
    assert rt.result_type(rt.zeros(2, dtype=np.int8), np.uint8) == np.int16

    def fake_unique(a):
        return "port unique"

    rt.implements(np.unique)(fake_unique)
    try:
        assert np.unique(rt.arange(3)) == "port unique"
    finally:
        interop.HANDLED_FUNCTIONS.pop(np.unique)
