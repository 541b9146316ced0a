"""``ramba_tpu_torch.fileio`` against ``ramba_tpu.fileio``, x64 regime.

* Files written by ramba_tpu (``.npy``, ``.h5`` and ``.rtd``, the last
  with one shard per device of its 8-device CPU mesh) load into the port
  with equal values and dtypes, and the port's files load into
  ramba_tpu the same way.
* ``Dataset``, ``register_loader``, the unknown-extension error, a PIL
  image and ``loadtxt``/``genfromtxt``/``savetxt`` agree with ramba_tpu.
* Reads and writes go through chunks of at most ``staging.CHUNK_BYTES``
  (``io_stats["max_chunk_bytes"]``), also across the shard boxes of a
  multi-shard ``.rtd``.
* ``fileio:once`` is retried; ``fileio:always`` raises
  ``RetryBudgetExhausted`` with the injected fault chained.

Mirrors ``tests/test_skeletons.py:729-830`` and
``tests/test_resilience.py:476``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, fileio
from ramba_tpu_torch.core import staging
from ramba_tpu_torch.observe import registry
from ramba_tpu_torch.resilience import faults, retry

DTYPES = ["float64", "float32", "int64", "int32", "uint8", "bool",
          "complex128"]
SHAPES = [(1000,), (64, 24), (6, 5, 7), (3,), ()]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0.001")
    faults.configure(None)
    yield
    faults.reset()


def _data(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    v = rs.rand(*shape) * 100 - 50 if shape else np.float64(rs.rand() * 9)
    if dtype == "complex128":
        v = v + 1j * (rs.rand(*shape) if shape else 0.5)
    return np.asarray(v).astype(dtype)


def _same(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _reset_stats():
    fileio.io_stats.update(chunks=0, max_chunk_bytes=0, whole_array_reads=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ext", ["npy", "rtd", "h5"])
def test_reference_writes_port_reads(tmp_path, ext, dtype, shape):
    if ext == "h5":
        pytest.importorskip("h5py")
    v = _data(shape, dtype)
    p = str(tmp_path / f"a.{ext}")
    rtj.save(p, rtj.fromarray(v))
    got = rt.load(p)
    assert isinstance(got, rt.ndarray)
    _same(got.asarray(), v)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ext", ["npy", "rtd", "h5"])
def test_port_writes_reference_reads(tmp_path, ext, dtype, shape):
    if ext == "h5":
        pytest.importorskip("h5py")
    v = _data(shape, dtype, seed=1)
    p = str(tmp_path / f"b.{ext}")
    rt.save(p, rt.fromarray(v))
    _same(np.asarray(rtj.load(p).asarray()), v)
    _same(rt.load(p).asarray(), v)


def test_reference_rtd_is_multi_shard_and_reassembles_in_chunks(
        tmp_path, monkeypatch):
    v = _data((64, 48), "float64")
    p = str(tmp_path / "m.rtd")
    rtj.save(p, rtj.fromarray(v))
    parts = [json.load(open(os.path.join(p, f))) for f in os.listdir(p)
             if f.startswith("manifest")]
    assert sum(len(m["shards"]) for m in parts) > 1
    # chunks of 5 rows cross the writer's 8-row shard boxes
    monkeypatch.setattr(staging, "CHUNK_BYTES", 5 * 48 * 8)
    _reset_stats()
    got = rt.load(p)
    _same(got.asarray(), v)
    assert fileio.io_stats["chunks"] == 13
    assert fileio.io_stats["max_chunk_bytes"] <= 5 * 48 * 8


def test_port_rtd_layout(tmp_path):
    v = _data((10, 3), "int64")
    p = str(tmp_path / "c.rtd")
    rt.save(p, rt.fromarray(v))
    assert sorted(os.listdir(p)) == ["manifest.p0.json", "shard_p0_0.npy"]
    m = json.load(open(os.path.join(p, "manifest.p0.json")))
    assert m == {"shape": [10, 3], "dtype": "int64", "nproc": 1,
                 "shards": [{"file": "shard_p0_0.npy", "start": [0, 0],
                             "stop": [10, 3]}]}
    # a second save into the same directory replaces its own files; a
    # host array is written from the host
    rt.save(p, rt.fromarray(v * 2))
    _same(rt.load(p).asarray(), v * 2)
    rt.save(p, v * 3)
    _same(np.asarray(rtj.load(p).asarray()), v * 3)


def test_rtd_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        rt.load(str(tmp_path / "none.rtd"))
    p = str(tmp_path / "d.rtd")
    rt.save(p, rt.fromarray(np.arange(8.0)))
    mp = os.path.join(p, "manifest.p0.json")
    m = json.load(open(mp))
    m["nproc"] = 2
    json.dump(m, open(mp, "w"))
    with pytest.raises(ValueError, match="2 processes"):
        rt.load(p)
    m["nproc"] = 1
    m["shards"][0]["stop"] = [4]
    json.dump(m, open(mp, "w"))
    with pytest.raises(ValueError, match="does not cover"):
        rt.load(p)
    os.remove(os.path.join(p, "shard_p0_0.npy"))
    with pytest.raises(FileNotFoundError, match="missing"):
        rt.load(p)


@pytest.mark.parametrize("ext", ["npy", "rtd", "h5"])
def test_chunk_bound_in_io_stats(tmp_path, monkeypatch, ext):
    if ext == "h5":
        pytest.importorskip("h5py")
    monkeypatch.setattr(staging, "CHUNK_BYTES", 4096)
    v = _data((100, 64), "float64")  # 51200 bytes: 13 chunks of 8 rows
    p = str(tmp_path / f"e.{ext}")
    _reset_stats()
    rt.save(p, rt.fromarray(v))
    assert fileio.io_stats["chunks"] == 13
    assert fileio.io_stats["max_chunk_bytes"] == 8 * 64 * 8
    _reset_stats()
    got = rt.load(p)
    assert fileio.io_stats["whole_array_reads"] == 0
    assert fileio.io_stats["chunks"] == 13
    assert fileio.io_stats["max_chunk_bytes"] <= 4096
    _same(got.asarray(), v)


def test_rows_wider_than_the_bound_split_inside_the_row(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(staging, "CHUNK_BYTES", 1000)
    v = _data((3, 4, 500), "float32")  # a (4, 500) block is 8000 bytes
    p = str(tmp_path / "w.npy")
    _reset_stats()
    rt.save(p, rt.fromarray(v))
    assert fileio.io_stats["max_chunk_bytes"] <= 1000
    _same(rt.load(p).asarray(), v)
    assert fileio.io_stats["max_chunk_bytes"] <= 1000


def test_npy_roundtrip_and_small_single_read(tmp_path):
    p = str(tmp_path / "x.npy")
    v = np.arange(100.0).reshape(10, 10)
    rt.save(p, rt.fromarray(v))
    _reset_stats()
    back = rt.load(p)
    assert fileio.io_stats["whole_array_reads"] == 1
    assert fileio.io_stats["chunks"] == 0
    _same(back.asarray(), v)
    _reset_stats()
    rt.save(str(tmp_path / "g.npy"), v)  # a host array saves in one piece
    assert fileio.io_stats["whole_array_reads"] == 1
    _same(np.load(str(tmp_path / "g.npy")), v)


def test_dataset_lazy(tmp_path):
    p = str(tmp_path / "y.npy")
    np.save(p, np.ones(5))
    ds, ds_j = rt.Dataset(p), rtj.Dataset(p)
    assert ds._arr is None
    assert ds.shape == ds_j.shape == (5,)
    _same((ds[2:] + 1).asarray(), np.asarray((ds_j[2:] + 1).asarray()))


def test_unknown_extension():
    with pytest.raises(ValueError, match="no loader registered"):
        rt.load("file.xyz")
    with pytest.raises(ValueError, match="no saver"):
        rt.save("file.xyz", np.ones(3))


def test_custom_loader(tmp_path):
    def my_loader(path, key):
        return rt.fromarray(np.full(3, 7.0))

    rt.register_loader(".MyExt", my_loader)
    _same(rt.load(str(tmp_path / "a.myext")).asarray(), np.full(3, 7.0))


def test_image_loader_matches_reference(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    px = (np.arange(12 * 9 * 3) % 251).astype(np.uint8).reshape(12, 9, 3)
    p = str(tmp_path / "img.png")
    Image.fromarray(px).save(p)
    got = rt.load(p).asarray()
    _same(got, np.asarray(rtj.load(p).asarray()))
    _same(got, px)


def test_netcdf_loader_is_import_gated(tmp_path):
    try:
        import netCDF4  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="netCDF4"):
            rt.load(str(tmp_path / "x.nc"))
    else:
        pytest.skip("netCDF4 is installed: the gate is not reached")


def test_text_io_matches_reference(tmp_path):
    v = np.arange(12.0).reshape(4, 3) / 7
    p, pj = str(tmp_path / "t.txt"), str(tmp_path / "tj.txt")
    rt.savetxt(p, rt.fromarray(v), delimiter=",", header="a,b,c")
    rtj.savetxt(pj, rtj.fromarray(v), delimiter=",", header="a,b,c")
    assert open(p).read() == open(pj).read()
    _same(rt.loadtxt(p, delimiter=",").asarray(),
          np.asarray(rtj.loadtxt(p, delimiter=",").asarray()))
    _same(rt.loadtxt(p, delimiter=",", usecols=(0, 2), ndmin=2).asarray(),
          np.asarray(rtj.loadtxt(p, delimiter=",", usecols=(0, 2),
                                 ndmin=2).asarray()))
    with open(p, "a") as f:
        f.write("1.0,,3.0\n")
    _same(rt.genfromtxt(p, delimiter=",").asarray(),
          np.asarray(rtj.genfromtxt(p, delimiter=",").asarray()))


def test_fileio_read_retries_transient_fault(tmp_path):
    p = tmp_path / "fileio_retry.npy"
    data = np.arange(4096, dtype=np.float32)
    np.save(p, data)
    before = registry.get("resilience.retries.fileio")
    with faults.inject("fileio", "once"):
        out = rt.load(str(p)).asarray()
    _same(out, data)
    assert registry.get("resilience.retries.fileio") == before + 1


def test_fileio_write_retries_transient_fault(tmp_path):
    p = str(tmp_path / "w.rtd")
    before = registry.get("resilience.retries.fileio")
    faults.configure("fileio:once")
    rt.save(p, rt.fromarray(np.arange(10)))
    assert registry.get("resilience.retries.fileio") == before + 1
    faults.configure(None)
    _same(rt.load(p).asarray(), np.arange(10))


def test_fileio_always_exhausts_with_cause(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_RETRY_FILEIO_ATTEMPTS", "2")
    p = tmp_path / "z.npy"
    np.save(p, np.ones(4))
    faults.configure("fileio:always")
    with pytest.raises(retry.RetryBudgetExhausted) as ei:
        rt.load(str(p))
    assert isinstance(ei.value.__cause__, faults.InjectedFault)
    assert faults.stats()["fileio"] == {"calls": 2, "fired": 2}


def test_missing_file_is_fatal_not_retried(tmp_path):
    before = registry.get("resilience.retries.fileio")
    with pytest.raises(FileNotFoundError):
        rt.load(str(tmp_path / "absent.npy"))
    assert registry.get("resilience.retries.fileio") == before


def test_loads_land_on_the_port_device(tmp_path):
    p = str(tmp_path / "d.npy")
    np.save(p, np.arange(6.0))
    assert rt.load(p)._value().device == common.device()


@pytest.mark.parametrize("name", ["x.npy", "x.rtd", "x.txt"])
def test_several_processes_wait_for_multi_gpu(tmp_path, monkeypatch, name):
    from ramba_tpu_torch.observe import events

    # several processes are the process group's (tests/test_torch_
    # distributed.py writes and reads across ranks); the event stream's
    # identity alone forms no group, so this process writes the file
    monkeypatch.setattr(events, "rank_info", lambda: (1, 2))
    save = rt.savetxt if name.endswith(".txt") else rt.save
    load = rt.loadtxt if name.endswith(".txt") else rt.load
    save(str(tmp_path / name), rt.arange(4.0))
    np.testing.assert_array_equal(load(str(tmp_path / name)).asarray(),
                                  np.arange(4.0))


def test_rtd_of_bfloat16_reads_its_manifest_dtype(tmp_path):
    import ml_dtypes

    v = (np.arange(30) / 7).astype(ml_dtypes.bfloat16).reshape(5, 6)
    p = str(tmp_path / "b.rtd")
    rt.save(p, rt.fromarray(v))
    got = rt.load(p).asarray()
    assert got.dtype == v.dtype
    np.testing.assert_array_equal(got.view(np.uint16), v.view(np.uint16))
