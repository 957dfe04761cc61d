"""Port parity: the dataset factory of ce5g_torch (the native block codec
and the .ce5g container, DatasetGenerator with its manifests, resume and
writers, verify_dataset, the Wiener sidecars and ChannelDataset's sidecar
branch) against ce5g_tpu, on the CPU.

Files pass between the packages in both directions. A port sample is a
pure function of (seed, split, chunk size, index, device type), so port
splits are compared with port splits bitwise, and with the JAX package's
by schema, verification result and the features computed from the same
files.
"""
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

import ce5g_torch.native as tnative
import ce5g_tpu.native as jnative
from ce5g_torch.data import ce5g_format as tfmt
from ce5g_torch.data.generator import (CHUNK_KEYS, DatasetGenerator, chunk_range_for_writer,
                                       read_chunk, read_split)
from ce5g_torch.train import ChannelDataset
from ce5g_tpu.data import ce5g_format as jfmt

from _torch_parity import one_torch_thread, port_cfg  # noqa: F401 (a fixture)

# bitwise comparisons of two CPU runs: one thread, a fixed reduction order
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIDECAR_TOL = 1e-3  # max |port − JAX| over the frame's rms (ROADMAP queue 3 item 2)


def _quiet(*_):
    pass


def _with_dataset(jcfg, fmt="ce5g", chunk=4):
    return dataclasses.replace(
        jcfg, dataset=dataclasses.replace(jcfg.dataset, save_format=fmt, chunk_size=chunk))


def _port_gen(small_cfg, out, fmt="ce5g", chunk=4):
    return DatasetGenerator(port_cfg(_with_dataset(small_cfg, fmt, chunk)), out, device="cpu")


def _assert_arrays_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _container_arrays():
    rng = np.random.default_rng(1)
    c = rng.standard_normal((7, 6, 2, 39)) + 1j * rng.standard_normal((7, 6, 2, 39))
    return {
        "H_true": c.astype(np.complex64),
        "pilot_mask": rng.integers(0, 2, (7, 6, 39)).astype(np.float32),
        "snr_db": rng.uniform(-5, 30, (7,)).astype(np.float32),
        "profile_idx": rng.integers(0, 3, (7,)).astype(np.int32),
        "channel_type": np.asarray(["EPA", "EVA", "ETU", "EPA", "EVA", "ETU", "EPA"], "<U10"),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.asarray(3.5, np.float64).reshape(()),
    }


def _header(path):
    with open(path, "rb") as f:
        f.read(8)
        return json.loads(f.read(int.from_bytes(f.read(8), "little")))


# ------------------------------------------------------------- codec, container
def test_native_codec_builds_into_the_ports_build_dir():
    assert tnative.have_native()
    assert tnative._BUILD.name == "_build" and tnative._BUILD.parent.name == "ce5g_torch"
    assert any(tnative._BUILD.glob("libce5gcodec-*.so"))


@pytest.mark.parametrize("itemsize", [1, 4, 8, 16])
def test_block_roundtrip_and_jax_reads_it(itemsize):
    rng = np.random.default_rng(itemsize)
    raw = rng.integers(0, 256, size=3 * 4096 + 123, dtype=np.uint8).tobytes()
    packed, sizes, backend = tnative.compress_blocks(raw, block_size=4096, itemsize=itemsize)
    assert backend == "zstd-shuffle" and len(sizes) == 4
    for codec in (tnative, jnative):
        back = codec.decompress_blocks(packed, sizes, len(raw), block_size=4096,
                                       itemsize=itemsize, backend=backend)
        assert bytes(back) == raw


def test_zlib_backend_roundtrip(monkeypatch):
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    raw = np.arange(10000, dtype=np.float32).tobytes()
    packed, sizes, backend = tnative.compress_blocks(raw, block_size=8192, itemsize=4)
    assert backend == "zlib" and len(sizes) == 5
    back = tnative.decompress_blocks(packed, sizes, len(raw), block_size=8192, itemsize=4,
                                     backend="zlib")
    assert bytes(back) == raw


def test_empty_buffer():
    packed, sizes, backend = tnative.compress_blocks(b"")
    assert sizes == [] and packed == b""
    assert bytes(tnative.decompress_blocks(packed, sizes, 0, backend=backend)) == b""


@pytest.mark.parametrize("fault", ["magic", "zstd-shuffle", "zlib"])
def test_bad_files_raise(tmp_path, monkeypatch, fault):
    import zlib

    path = tmp_path / "chunk.ce5g"
    if fault == "magic":
        np.savez(tmp_path / "chunk.npz", a=np.zeros(3))
        shutil.copy(tmp_path / "chunk.npz", path)
        with pytest.raises(ValueError, match="not a .ce5g file"):
            tfmt.read_ce5g(path)
        return
    if fault == "zlib":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    tfmt.write_ce5g(path, {"x": np.random.default_rng(0).standard_normal(50000)})
    assert _header(path)["writer"] == fault
    raw = bytearray(path.read_bytes())
    raw[-20:] = b"\x00" * 20  # stomp the end of the compressed payload
    path.write_bytes(bytes(raw))
    with pytest.raises((ValueError, zlib.error)):
        tfmt.read_ce5g(path)


@pytest.mark.parametrize("backend", ["zstd-shuffle", "zlib"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ce5g_files_cross_read_bitwise(tmp_path, monkeypatch, writer, backend):
    """A .ce5g written by either package reads bitwise in the other, through
    either codec backend, channel_type strings included."""
    if backend == "zlib":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    write, read = ((jfmt.write_ce5g, tfmt.read_ce5g) if writer == "jax"
                   else (tfmt.write_ce5g, jfmt.read_ce5g))
    arrays = _container_arrays()
    path = tmp_path / "chunk.ce5g"
    write(path, arrays)
    header = _header(path)
    assert header["writer"] == backend
    assert {m["backend"] for m in header["arrays"]} == {backend}
    _assert_arrays_equal(read(path), arrays)


# -------------------------------------------------------------------- generator
def test_chunk_range_for_writer_equals_jax():
    from ce5g_tpu.data.generator import chunk_range_for_writer as j_range

    for n in (0, 1, 2, 5, 7, 16, 33):
        for writers in (1, 2, 3, 4, 5, 8):
            for w in range(writers):
                assert chunk_range_for_writer(n, writers, w) == j_range(n, writers, w)
    with pytest.raises(ValueError):
        chunk_range_for_writer(4, 2, 2)


@pytest.fixture(scope="module")
def jax_split(small_cfg, tmp_path_factory):
    """A 6-frame .ce5g train split in chunks of 4 made by the JAX package."""
    from ce5g_tpu.data.generator import DatasetGenerator as JGenerator

    root = tmp_path_factory.mktemp("jax_split")
    JGenerator(_with_dataset(small_cfg), str(root)).generate_split("train", 6, log=_quiet)
    return root


def test_chunk_schema_equals_jax(small_cfg, jax_split, tmp_path):
    """The port's chunk files have the JAX package's keys, dtypes and
    shapes; on the device a chunk is the CHUNK_KEYS tensors."""
    gen = _port_gen(small_cfg, tmp_path)
    manifest = gen.generate_split("train", 6, log=_quiet)
    jman = json.loads((jax_split / "train_manifest.json").read_text())
    assert manifest["files"] == jman["files"]
    assert set(manifest) == set(jman)
    for name in manifest["files"]:
        got, ref = read_chunk(tmp_path / name), read_chunk(jax_split / name)
        assert got.keys() == ref.keys()
        for k in ref:
            assert (got[k].dtype, got[k].shape) == (ref[k].dtype, ref[k].shape), k
    tensors = gen.chunk_tensors("train", 0)
    assert tuple(tensors) == CHUNK_KEYS and tensors["H_ls"].shape[0] == 4


def test_no_package_resumes_the_others_split(small_cfg, jax_split, tmp_path):
    """The fingerprint holds the generator family and the chunk size, so a
    resume regenerates the other package's split rather than mixing it in."""
    from ce5g_tpu.data.generator import DatasetGenerator as JGenerator

    ported = tmp_path / "ported"
    shutil.copytree(jax_split, ported)
    gen = _port_gen(small_cfg, ported)
    fp = json.loads(gen._fingerprint())
    assert (fp["rng"], fp["chunk_size"]) == ("torch-cpu", 4)
    gen.generate_split("train", 6, resume=True, log=_quiet)
    fresh = _port_gen(small_cfg, tmp_path / "fresh")
    fresh.generate_split("train", 6, log=_quiet)
    got = read_split(ported / "train_manifest.json")
    _assert_arrays_equal(got, read_split(tmp_path / "fresh" / "train_manifest.json"))
    assert not np.array_equal(got["H_true"], read_split(jax_split / "train_manifest.json")["H_true"])
    # and the JAX package regenerates a port split
    JGenerator(_with_dataset(small_cfg), str(ported)).generate_split("train", 6, resume=True,
                                                                      log=_quiet)
    _assert_arrays_equal(read_split(ported / "train_manifest.json"),
                         read_split(jax_split / "train_manifest.json"))


def test_resume_regenerates_a_deleted_chunk_bitwise(small_cfg, tmp_path):
    gen = _port_gen(small_cfg, tmp_path)
    gen.generate_split("train", 10, log=_quiet)
    ref = {name: read_chunk(tmp_path / name)
           for name in json.loads((tmp_path / "train_manifest.json").read_text())["files"]}
    (tmp_path / "train_chunk_00001.ce5g").unlink()
    manifest = gen.generate_split("train", 10, resume=True, log=_quiet)
    assert manifest["files"] == sorted(ref) and manifest["completed"] == 10
    for name, arrays in ref.items():
        _assert_arrays_equal(read_chunk(tmp_path / name), arrays)


@pytest.mark.parametrize("before, after", [(6, 10), (10, 6)])
def test_grow_and_shrink_keep_the_valid_prefix(small_cfg, tmp_path, before, after):
    """Full chunks valid under both totals are kept (untouched on disk); the
    rest is regenerated or pruned, and the split equals a fresh one."""
    gen = _port_gen(small_cfg, tmp_path / "resumed")
    gen.generate_split("train", before, log=_quiet)
    first = tmp_path / "resumed" / "train_chunk_00000.ce5g"
    mtime = first.stat().st_mtime_ns
    manifest = gen.generate_split("train", after, resume=True, log=_quiet)
    assert first.stat().st_mtime_ns == mtime
    fresh = _port_gen(small_cfg, tmp_path / "fresh")
    ref = fresh.generate_split("train", after, log=_quiet)
    assert manifest["files"] == ref["files"] and manifest["completed"] == after
    assert sorted(p.name for p in (tmp_path / "resumed").glob("train_chunk_*")) == ref["files"]
    _assert_arrays_equal(read_split(tmp_path / "resumed" / "train_manifest.json"),
                         read_split(tmp_path / "fresh" / "train_manifest.json"))


def test_trailing_partial_chunk_is_the_prefix_of_the_full_chunk(small_cfg, tmp_path):
    gen = _port_gen(small_cfg, tmp_path)
    full = gen._run_chunk("val", 3, 4)
    part = gen._run_chunk("val", 3, 2)
    _assert_arrays_equal(part, {k: v[:2] for k, v in full.items()})
    other = gen._run_chunk("val", 2, 4)
    assert not np.array_equal(other["H_true"], full["H_true"])


def test_two_writers_equal_one_writer(small_cfg, tmp_path):
    from ce5g_torch.data import verify_dataset

    single = _port_gen(small_cfg, tmp_path / "single")
    single.generate_split("train", 10, log=_quiet)
    gen = _port_gen(small_cfg, tmp_path / "multi")
    for w in range(2):
        m = gen.generate_split("train", 10, log=_quiet, writer_id=w, num_writers=2)
        assert m["completed"] == m["owned_samples"] and m["chunk_range"] == [[0, 2], [2, 3]][w]
    g = gen.write_global_manifest("train", num_writers=2)
    assert g["completed"] == 10 and g["files"] == [f"train_chunk_{i:05d}.ce5g" for i in range(3)]
    _assert_arrays_equal(read_split(tmp_path / "multi" / "train_manifest.json"),
                         read_split(tmp_path / "single" / "train_manifest.json"))
    assert verify_dataset(str(tmp_path / "multi" / "train_manifest.json"))["passed"]


def test_incomplete_writers_are_refused(small_cfg, tmp_path):
    gen = _port_gen(small_cfg, tmp_path)
    gen.generate_split("val", 10, log=_quiet, writer_id=0, num_writers=2)
    with pytest.raises(FileNotFoundError, match="per-writer manifest"):
        gen.write_global_manifest("val", num_writers=2)
    gen.generate_split("val", 10, log=_quiet, writer_id=1, num_writers=2)
    part = tmp_path / "val_manifest_w001.json"
    m = json.loads(part.read_text())
    part.write_text(json.dumps(dict(m, completed=m["owned_samples"] - 1)))
    with pytest.raises(ValueError, match="incomplete"):
        gen.write_global_manifest("val", num_writers=2)


def test_writers_default_to_the_process_group(small_cfg, tmp_path, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    m = _port_gen(small_cfg, tmp_path).generate_split("test", 10, log=_quiet)
    assert (m["writer_id"], m["num_writers"], m["chunk_range"]) == (1, 2, [2, 3])
    assert (tmp_path / "test_manifest_w001.json").exists()
    assert [p.name for p in tmp_path.glob("test_chunk_*")] == ["test_chunk_00002.ce5g"]


@pytest.mark.parametrize("fmt", ["npz", "ce5g", "h5"])
def test_merge_split(small_cfg, tmp_path, fmt):
    from ce5g_tpu.data.generator import read_split as j_read_split

    gen = _port_gen(small_cfg, tmp_path, fmt=fmt)
    gen.generate_split("test", 6, log=_quiet)
    merged = gen.merge_split("test")
    assert merged.endswith(f"test.{fmt}")
    ref = read_split(tmp_path / "test_manifest.json")
    _assert_arrays_equal(read_split(merged), ref)
    _assert_arrays_equal(j_read_split(merged), ref)
    assert len(ChannelDataset(merged)) == 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_h5_round_trips_with_jax(tmp_path, writer):
    from ce5g_torch.data import generator as tgen
    from ce5g_tpu.data import generator as jgen

    arrays = {k: v for k, v in _container_arrays().items() if k not in ("empty", "scalar")}
    write, read = ((jgen._write_h5, tgen._read_h5) if writer == "jax"
                   else (tgen._write_h5, jgen._read_h5))
    write(tmp_path / "s.h5", arrays)
    _assert_arrays_equal(read(tmp_path / "s.h5"), arrays)


# ----------------------------------------------------------------------- verify
@pytest.mark.parametrize("case", ["sound", "nan", "missing_key", "count"])
def test_verify_equals_jax(small_cfg, tmp_path, case):
    from ce5g_torch.data import verify_dataset
    from ce5g_tpu.data.verify import verify_dataset as j_verify

    _port_gen(small_cfg, tmp_path).generate_split("train", 6, log=_quiet)
    mpath = tmp_path / "train_manifest.json"
    names = json.loads(mpath.read_text())["files"]
    if case in ("nan", "missing_key"):
        for name in names:
            arrays = read_chunk(tmp_path / name)
            if case == "nan":
                arrays["H_ls"][0, 1, 0, 0, 3] = np.nan
            else:
                del arrays["pilot_mask"]
            tfmt.write_ce5g(tmp_path / name, arrays)
    elif case == "count":
        mpath.write_text(json.dumps(dict(json.loads(mpath.read_text()), total=7)))
    got, ref = verify_dataset(str(mpath)), j_verify(str(mpath))
    assert got == ref
    failed = {name for name, c in got["checks"].items() if not c["passed"]}
    assert failed == {"sound": set(), "nan": {"finite", "ls_quality"}, "missing_key": {"schema"},
                      "count": {"sample_count"}}[case]


# --------------------------------------------------------------------- sidecars
@pytest.fixture(scope="module")
def sidecars(tmp_path_factory):
    """A 6-frame SIMO split (chunks of 4, at −5 to 5 dB and 5-10% pilots)
    made by the port, with the JAX package's sidecars (batches of 2) in
    one copy and the port's (batches of 3, so the last batch of each
    chunk is shorter) in another."""
    from ce5g_tpu.config import load_config
    from ce5g_tpu.data.wiener import compute_wiener_sidecar as j_sidecar
    from ce5g_torch.data import compute_wiener_sidecar

    jcfg = load_config("configs/simo_identifiable.yaml")
    jcfg = dataclasses.replace(
        _with_dataset(jcfg),
        simulation=dataclasses.replace(jcfg.simulation, snr_range_db=(-5.0, 0.0, 5.0)),
        pilots=dataclasses.replace(jcfg.pilots, density=(0.05, 0.1)),
    )
    root = tmp_path_factory.mktemp("sidecars")
    DatasetGenerator(port_cfg(jcfg), root / "port", device="cpu").generate_split(
        "test", 6, log=_quiet)
    shutil.copytree(root / "port", root / "jax")
    for estimator, tag in (("mmse_full", "wiener"), ("mmse_full_est", "bwiener")):
        j_sidecar(jcfg, root / "jax" / "test_manifest.json", batch_size=2, estimator=estimator,
                  tag=tag, log=_quiet)
        compute_wiener_sidecar(port_cfg(jcfg), root / "port" / "test_manifest.json",
                               batch_size=3, estimator=estimator, tag=tag, log=_quiet,
                               device="cpu")
    return jcfg, root


def _sidecar(root, tag):
    wm = json.loads((root / f"test_{tag}_manifest.json").read_text())
    return np.concatenate([read_chunk(root / f)["H_wiener"] for f in wm["files"]])


def _rel_err(got, ref):
    err = np.max(np.abs(got - ref), axis=(1, 2))
    return err / np.sqrt(np.mean(np.abs(ref) ** 2, axis=(1, 2)))


def test_wiener_sidecar_matches_jax(sidecars):
    _, root = sidecars
    got, ref = _sidecar(root / "port", "wiener"), _sidecar(root / "jax", "wiener")
    assert got.shape == ref.shape == (6, 14, 599) and got.dtype == np.complex64
    assert np.all(_rel_err(got, ref) <= SIDECAR_TOL), _rel_err(got, ref)


def test_blind_sidecar_matches_jax_where_the_priors_agree(sidecars):
    """mmse_full_est at ≤ 5 dB, on the frames whose profile and Doppler the
    two packages' blind fits chose alike (tests/test_torch_blind.py)."""
    import ce5g_tpu.estimators.blind as jblind
    from ce5g_torch.estimators.blind import device_tables_for, estimate_priors
    from ce5g_torch.eval.evaluate import _frames_from_arrays
    from ce5g_torch.physics.simulate import table_for
    from ce5g_tpu.physics.simulate import table_for as j_table_for

    jcfg, root = sidecars
    tcfg = port_cfg(jcfg)
    arrays = read_split(root / "port" / "test_manifest.json")
    f = _frames_from_arrays(arrays, np.arange(6), tcfg, "cpu")
    pri = estimate_priors(f.rx_symbols, f.tx_symbols[:, :, 0, :], f.pilot_mask,
                          device_tables_for(tcfg, table_for(tcfg), "cpu"), tcfg.mimo.num_tx)
    tables = jblind.blind_tables_for(jcfg, j_table_for(jcfg))
    jpri = [jblind.estimate_priors(arrays["rx_symbols"][i], arrays["tx_symbols"][i, :, 0, :],
                                   arrays["pilot_mask"][i], tables, jcfg.mimo.num_tx)
            for i in range(6)]
    pick = np.array([int(pri.profile_idx[i]) == int(p.profile_idx)
                     and float(pri.doppler_hz[i]) == float(p.doppler_hz)
                     for i, p in enumerate(jpri)])
    assert pick.sum() >= 2 and np.all(arrays["snr_db"] <= 5.0)
    err = _rel_err(_sidecar(root / "port", "bwiener"), _sidecar(root / "jax", "bwiener"))
    assert np.all(err[pick] <= SIDECAR_TOL), err


def test_sidecar_manifests_equal_jax(sidecars):
    _, root = sidecars
    split_fp = json.loads((root / "port" / "test_manifest.json").read_text())["fingerprint"]
    for tag, estimator in (("wiener", "mmse_full"), ("bwiener", "mmse_full_est")):
        got, ref = (json.loads((root / pkg / f"test_{tag}_manifest.json").read_text())
                    for pkg in ("port", "jax"))
        assert got.keys() == ref.keys()
        assert got["files"] == ref["files"] == [f"test_{tag}_{i:05d}.ce5g" for i in range(2)]
        assert (got["split"], got["estimator"], got["source_fingerprint"]) == \
            (ref["split"], ref["estimator"], ref["source_fingerprint"]) == \
            ("test", estimator, split_fp)
        for name in got["files"]:
            assert list(read_chunk(root / "port" / name)) == ["H_wiener"]


def test_sidecar_does_not_depend_on_the_batch(sidecars, tmp_path):
    """Batches of 3 (a shorter last batch in each chunk) and of 4 give the
    same feature, up to the float32 rounding of mmse_full's solve, which
    follows the matmul's blocking of the batch (a tenth of the bound the
    JAX package's feature is held to)."""
    from ce5g_torch.data import compute_wiener_sidecar

    jcfg, root = sidecars
    out = {}
    for batch in (3, 4):
        shutil.copytree(root / "port", tmp_path / str(batch))
        compute_wiener_sidecar(port_cfg(jcfg), tmp_path / str(batch) / "test_manifest.json",
                               batch_size=batch, log=_quiet, device="cpu")
        out[batch] = _sidecar(tmp_path / str(batch), "wiener")
    assert np.all(_rel_err(out[4], out[3]) <= SIDECAR_TOL / 10), _rel_err(out[4], out[3])


@pytest.mark.parametrize("wiener", [True, "wiener", "bwiener"])
def test_channel_dataset_batches_equal_jax(sidecars, wiener):
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    _, root = sidecars
    manifest = root / "jax" / "test_manifest.json"
    got, ref = ChannelDataset(manifest, wiener=wiener), JChannelDataset(str(manifest),
                                                                        wiener=wiener)
    assert got.stats == ref.stats and len(got) == len(ref) == 6
    idx = np.array([5, 0, 3])
    for a, b in zip(got.make_batch(idx)[:3], ref.make_batch(idx)[:3]):
        np.testing.assert_array_equal(a, b)
    assert got.make_batch(idx).inputs.shape[-1] == 7


@pytest.mark.parametrize("fault", ["merged", "missing", "fingerprint", "length"])
def test_channel_dataset_sidecar_faults_raise_as_jax(small_cfg, tmp_path, fault):
    """Each fault raises the JAX package's exception on the same files."""
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    gen = _port_gen(small_cfg, tmp_path)
    gen.generate_split("val", 6, log=_quiet)
    path = tmp_path / "val_manifest.json"
    wm = {"split": "val", "estimator": "mmse_full", "files": ["val_wiener_00000.ce5g"],
          "source_fingerprint": gen._fingerprint()}
    tfmt.write_ce5g(tmp_path / "val_wiener_00000.ce5g",
                    {"H_wiener": np.ones((6, 6, 39), np.complex64)})
    error = ValueError
    if fault == "merged":
        path = gen.merge_split("val")
    elif fault == "missing":
        error = FileNotFoundError
    elif fault == "fingerprint":
        wm["source_fingerprint"] = "another split"
    else:
        tfmt.write_ce5g(tmp_path / "val_wiener_00000.ce5g",
                        {"H_wiener": np.ones((5, 6, 39), np.complex64)})
    if fault != "missing":
        (tmp_path / "val_wiener_manifest.json").write_text(json.dumps(wm))
    for cls in (ChannelDataset, JChannelDataset):
        with pytest.raises(error):
            cls(str(path), wiener=True)
    if fault == "length":  # a sound sidecar of the right length joins
        tfmt.write_ce5g(tmp_path / "val_wiener_00000.ce5g",
                        {"H_wiener": np.ones((6, 6, 39), np.complex64)})
        x = ChannelDataset(path, wiener=True).make_batch(np.arange(2)).inputs
        assert x.shape == (2, 6, 39, 7) and torch.isfinite(torch.from_numpy(x)).all()


def test_experiment_config_literal_matches_yaml():
    """chip_smoke.py's copy of configs/experiment_config.yaml (phase 13's
    physics), field by field, against the port's and the JAX package's
    loaders."""
    import chip_smoke
    from ce5g_torch.config import config_from_dict, load_config
    from ce5g_tpu.config import load_config as j_load_config

    literal = dataclasses.asdict(config_from_dict(chip_smoke.EXPERIMENT_CONFIG))
    assert literal == dataclasses.asdict(load_config("configs/experiment_config.yaml"))
    assert literal == dataclasses.asdict(j_load_config("configs/experiment_config.yaml"))
