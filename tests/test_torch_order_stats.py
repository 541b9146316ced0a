"""The order statistics' shared arithmetic in one process
(``core/expr.py``: ``order_values``, ``order_key``, ``sorted_values``,
``median_positions``, ``median_finish``; ``ops/extras.py``:
``quantile_positions``, ``quantile_finish``), which the one-process
lowering and the selection across ranks (``core/rankselect.py``) both
call.

* The positions-plus-finish functions give the same bytes as the inline
  arithmetic they replaced (copied below as it stood), for all five
  methods, ``percent`` with a static count and with a NaN count, and
  ``keepdims``, on data whose sort has no ties of distinct bits.
* C.18: equal values keep their index order, so a median or quantile
  that lands on a zero has the sign of the zero ``jnp.sort`` puts there
  (``torch.sort`` is not stable: a signed zero's sign depended on it).
* ``order_key`` orders every float dtype as ``jnp.sort``: both zeros one
  key, every NaN last, and ``key_value`` inverts it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ramba_tpu_torch as rt
from ramba_tpu_torch import common
from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.ops import extras

METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")


def _inline_quantile(a, q, axis, keepdims, method, nan, percent):
    """The quantile's arithmetic as it stood inline before the split
    (sort, positions, gather, interpolation in one function)."""
    out_dt = E.to_torch_dtype(extras.inexact(E.to_np_dtype(a.dtype)))
    x = E.convert(a, out_dt)
    if axis is None:
        x, ax = x.reshape(-1), 0
    else:
        ax = axis % x.ndim
    x = torch.movedim(x, ax, -1)
    qd = q.dtype
    qb = q.reshape(q.shape + (1,) * x.ndim)
    n = float(x.shape[-1])
    static_count = not nan or not a.is_floating_point()
    if nan:
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
        s = torch.sort(x, dim=-1).values
        cnt = (~torch.isnan(s)).sum(-1, keepdim=True).to(qd)
        top = cnt - 1
    else:
        x = torch.where(torch.isnan(x).any(-1, keepdim=True),
                        torch.full_like(x, float("nan")), x)
        s = torch.sort(x, dim=-1).values
        top = torch.full((), n - 1, dtype=qd, device=x.device)
    if percent and static_count:
        qq = qb * ((n - 1) / 100)
    elif percent:
        qq = (qb * (1 / 100)) * top
    else:
        qq = qb * top
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    lw = 1 - hw
    zero = torch.zeros((), dtype=qd, device=x.device)
    low = torch.maximum(zero, torch.minimum(low, top)).to(torch.int64)
    high = torch.maximum(zero, torch.minimum(high, top)).to(torch.int64)
    sx = s.expand(q.shape + tuple(s.shape))
    lv = torch.gather(sx, -1, low.expand(q.shape + tuple(s.shape[:-1]) + (1,)))
    hv = torch.gather(sx, -1, high.expand(q.shape + tuple(s.shape[:-1]) + (1,)))
    if method == "linear":
        r = lv.to(qd) * lw + hv.to(qd) * hw
    elif method == "lower":
        r = lv
    elif method == "higher":
        r = hv
    elif method == "nearest":
        r = torch.where(hw <= 0.5, lv, hv)
    else:
        r = (lv + hv) * 0.5
    r = r[..., 0]
    if keepdims:
        r = r.unsqueeze(len(q.shape) + (0 if axis is None else ax)) \
            if axis is not None else r.reshape(q.shape + (1,) * a.ndim)
    return r.to(out_dt)


def _inline_median(y, dims, keepdims, skip_nan):
    """The median as it stood inline before the split."""
    nd = y.ndim
    keep = [d for d in range(nd) if d not in dims]
    out_shape = tuple(1 if d in dims else y.shape[d] for d in range(nd)) \
        if keepdims else tuple(y.shape[d] for d in keep)
    z = y.permute(*keep, *dims).reshape(*[y.shape[d] for d in keep], -1)
    n = z.shape[-1]
    if not skip_nan:
        z = torch.where(torch.any(torch.isnan(z), dim=-1, keepdim=True),
                        torch.full_like(z, float("nan")), z)
    s = torch.sort(z, dim=-1).values
    if skip_nan:
        cnt = torch.sum(~torch.isnan(z), dim=-1, keepdim=True)
        top = torch.clamp(cnt - 1, min=0)
        lo = torch.div(cnt - 1, 2, rounding_mode="floor")
        hi = cnt - 1 - lo
        lo = torch.minimum(torch.clamp(lo, min=0), top)
        hi = torch.minimum(torch.clamp(hi, min=0), top)
        low = torch.gather(s, -1, lo)[..., 0]
        high = torch.gather(s, -1, hi)[..., 0]
    else:
        low, high = s[..., (n - 1) // 2], s[..., n // 2]
    half = torch.full((), 0.5, dtype=s.dtype, device=s.device)
    return ((low + high) * half).reshape(out_shape)


def _data(dtype, nan):
    rng = np.random.default_rng(41)
    x = rng.standard_normal((7, 13)) * 50
    if np.dtype(dtype).kind in "iu":
        x = np.abs(x)
    x = x.astype(dtype)
    if nan and np.dtype(dtype).kind == "f":
        x[rng.random(x.shape) < 0.2] = np.nan
        x[2, :] = np.nan  # an all-NaN row
    return x


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "uint8"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fn", ["quantile", "percentile", "nanquantile",
                                "nanpercentile"])
def test_quantile_split_gives_the_same_bytes(fn, method, dtype):
    nan, percent = fn.startswith("nan"), fn.endswith("percentile")
    x = _data(dtype, nan)
    q = np.array([0.0, 13.0, 50.0, 87.5, 100.0]) if percent else \
        np.array([0.0, 0.13, 0.5, 0.875, 1.0])
    for axis in (None, 0, 1):
        for keepdims in (False, True):
            got = getattr(rt, fn)(rt.fromarray(x), q, axis=axis,
                                  keepdims=keepdims, method=method)
            want = _inline_quantile(torch.from_numpy(x), torch.from_numpy(q),
                                    axis, keepdims, method, nan, percent)
            _same(got, want.numpy(), (fn, method, dtype, axis, keepdims))


@pytest.mark.parametrize("dtype", ["float64", "float32", "float16"])
@pytest.mark.parametrize("fn", ["median", "nanmedian"])
def test_median_split_gives_the_same_bytes(fn, dtype):
    x = _data(dtype, True)
    for axis, dims in ((None, (0, 1)), (0, (0,)), (1, (1,))):
        for keepdims in (False, True):
            got = getattr(rt, fn)(rt.fromarray(x), axis=axis,
                                  keepdims=keepdims)
            want = _inline_median(torch.from_numpy(x), dims, keepdims,
                                  fn == "nanmedian")
            _same(got, want.numpy(), (fn, dtype, axis, keepdims))


def test_positions_and_finish_functions_directly():
    # the medians' positions: a plain count, and a nan kind's counts
    assert E.median_positions(7) == (3, 3)
    assert E.median_positions(8) == (3, 4)
    lo, hi = E.median_positions(9, torch.tensor([0, 1, 4, 9]))
    assert lo.tolist() == [0, 0, 1, 4] and hi.tolist() == [0, 0, 2, 4]
    low = torch.tensor([1.0, -0.0], dtype=torch.float16)
    got = E.median_finish(low, torch.tensor([2.0, -0.0], dtype=torch.float16))
    assert got.tolist() == [1.5, 0.0] and torch.signbit(got)[1]
    # the quantiles': percent with a static count rounds as q ((n - 1) / 100)
    qb = torch.tensor([[37.0]], dtype=torch.float64)
    top = torch.full((), 18.0, dtype=torch.float64)
    lo, hi, lw, hw = extras.quantile_positions(qb, 19.0, top, True, True)
    assert lo.item() == 6 and hi.item() == 7
    assert hw.item() == 37.0 * (18.0 / 100) - 6
    lo, hi, lw, hw = extras.quantile_positions(qb, 19.0, top, True, False)
    assert hw.item() == (37.0 * (1 / 100)) * 18.0 - 6
    lv, hv = torch.tensor([[1.0]]), torch.tensor([[3.0]])
    lw = torch.tensor([[0.25]], dtype=torch.float64)
    hw = torch.tensor([[0.75]], dtype=torch.float64)
    for method, want in (("linear", 2.5), ("lower", 1.0), ("higher", 3.0),
                         ("midpoint", 2.0), ("nearest", 3.0)):
        r = extras.quantile_finish(lv, hv, lw, hw, method, torch.float32)
        assert r.dtype == torch.float32 and r.item() == want, method


def test_equal_values_keep_their_index_order_as_jnp_sort():
    """C.18: a median or a quantile that lands on a zero holds the sign of
    the zero ``jnp.sort`` puts at that position (equal values in index
    order).  ``torch.sort`` is not stable, so the sign followed its
    internal order (28 of 40 such results differed from ``ramba_tpu``)."""
    for seed in range(20):
        rng = np.random.default_rng(seed)
        z = np.where(rng.random(301) < 0.5, -0.0, 0.0)
        z[:10], z[-12:] = -1.0, 2.0
        got = np.asarray(rt.median(rt.fromarray(z)))
        want = np.asarray(jnp.median(jnp.asarray(z)))
        assert np.signbit(got) == np.signbit(want), seed
        for m in ("lower", "higher", "nearest", "midpoint", "linear"):
            q = [0.3, 0.5, 0.6]
            got = np.asarray(rt.quantile(rt.fromarray(z), q, method=m))
            want = np.asarray(jnp.quantile(jnp.asarray(z), jnp.asarray(q),
                                           method=m))
            np.testing.assert_array_equal(np.signbit(got), np.signbit(want),
                                          err_msg=f"{seed} {m}")
        g = z.reshape(7, 43)
        got = np.asarray(rt.nanmedian(rt.fromarray(g), axis=1))
        want = np.asarray(jnp.nanmedian(jnp.asarray(g), axis=1))
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64])
def test_order_key_orders_as_jnp_sort(dtype):
    v = torch.tensor([-float("inf"), -3.5, -1e-3, -0.0, 0.0, 1e-3, 2.0,
                      float("inf"), float("nan"), -float("nan")],
                     dtype=dtype)
    k = E.order_key(v)
    assert k.dtype == E._KEY_DTYPES[dtype]
    assert (k[1:8] >= k[:7]).all() and k[3] == k[4] == 0
    assert k[8] == k[9] and k[8] > k[7]  # every NaN the one key, last
    back = E.key_value(k[:8], dtype)
    assert back[:3].tolist() == v[:3].tolist() and back[5:].tolist() == \
        v[5:8].tolist()
    assert not torch.signbit(back[3])  # the zero key is +0.0
    s = E.sorted_values(torch.tensor([0.0, -0.0, 1.0, -0.0, float("nan"),
                                      -1.0], dtype=dtype))
    assert torch.signbit(s).tolist()[:4] == [True, False, True, True]
