"""Artifact I/O in the PyTorch port against the JAX reference: the
checked-in manifest-v1 artifact reads identically through both packages,
stores written by the port are byte-identical to the reference's for the
same units and level (bf16 byte planes included), and each package reads
the other's blob."""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import tensorstore_lite as ref_tsl
from repro.core import optional_store as ref_store
from repro_torch.checkpoint import tensorstore_lite as tsl
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import optional_store as store

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "phi3-medium-14b-reduced")


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def _units(dtype):
    rs = np.random.default_rng(3)
    shapes = [(64, 64), (2, 32, 16), (7,), (5, 3)]
    return [(f"u{i}", (rs.standard_normal(s) * 0.1).astype(dtype)) for i, s in enumerate(shapes)]


def test_checked_in_v1_store_reads_identically():
    path = os.path.join(ARTIFACT, "optional.blob")
    mine, ref = store.OptionalStore(path), ref_store.OptionalStore(path)
    try:
        assert mine.version == ref.version == 1
        assert sorted(mine.keys()) == sorted(ref.keys())
        for key in ref.keys():
            np.testing.assert_array_equal(_np(mine.fetch(key)), ref.fetch(key))
        assert mine.raw_bytes == ref.raw_bytes
        assert mine.compressed_bytes == ref.compressed_bytes
    finally:
        mine.close()
        ref.close()


def test_checked_in_tier0_bundle_reads_identically():
    prefix = os.path.join(ARTIFACT, "tier0")
    mine = tsl.read_bundle(prefix)
    ref = ref_tsl.read_bundle(prefix, mmap=False)
    assert list(mine) == list(ref)
    for key, arr in ref.items():
        np.testing.assert_array_equal(_np(mine[key]), arr)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int32],
                         ids=["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("level", [0, 1, 6])
def test_port_store_is_byte_identical(tmp_path, dtype, level):
    units = _units(dtype)
    ref_path, my_path = str(tmp_path / "ref.blob"), str(tmp_path / "port.blob")
    ref_store.write_store(ref_path, units, level=level)
    store.write_store(my_path, [(k, tensor_from_numpy(a, "cpu")) for k, a in units], level=level)
    for suffix in ("", ".manifest.json"):
        with open(ref_path + suffix, "rb") as f1, open(my_path + suffix, "rb") as f2:
            assert f1.read() == f2.read(), suffix
    codecs = {e.codec for e in store.OptionalStore(my_path).entries.values()}
    want = {"raw"} if level == 0 else {"zlib-bp" if dtype == ml_dtypes.bfloat16 else "zlib"}
    assert codecs == want


@pytest.mark.parametrize("level", [1, 3])
def test_threaded_writer_is_byte_identical(tmp_path, level):
    units = _units(ml_dtypes.bfloat16) + _units(np.float32)
    units = [(f"{k}-{i}", a) for i, (k, a) in enumerate(units)]
    ref_path, my_path = str(tmp_path / "ref.blob"), str(tmp_path / "port.blob")
    ref_store.write_store(ref_path, units, level=level)
    with store.OptionalStoreWriter(my_path, level=level) as w:
        w.add_all((k, tensor_from_numpy(a, "cpu")) for k, a in units)
    with open(ref_path, "rb") as f1, open(my_path, "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["float32", "bfloat16"])
def test_each_package_reads_the_others_blob(tmp_path, dtype):
    units = _units(dtype)
    ref_path, my_path = str(tmp_path / "ref.blob"), str(tmp_path / "port.blob")
    ref_store.write_store(ref_path, units, level=6)
    store.write_store(my_path, [(k, tensor_from_numpy(a, "cpu")) for k, a in units], level=6)
    mine_reads_ref = store.OptionalStore(ref_path)
    ref_reads_mine = ref_store.OptionalStore(my_path)
    for key, arr in units:
        np.testing.assert_array_equal(_np(mine_reads_ref.fetch(key)), arr)
        np.testing.assert_array_equal(ref_reads_mine.fetch(key), arr)
    many = mine_reads_ref.read_raw_many([k for k, _ in units])
    assert all(many[k] == mine_reads_ref.read_raw(k) for k, _ in units)


def test_bundle_round_trip_between_packages(tmp_path):
    arrays = dict(_units(ml_dtypes.bfloat16))
    arrays["f32"] = np.arange(12, dtype=np.float32).reshape(3, 4)
    ref_tsl.write_bundle(str(tmp_path / "ref"), arrays)
    tsl.write_bundle(str(tmp_path / "port"), {k: tensor_from_numpy(a, "cpu") for k, a in arrays.items()})
    for suffix in (".bin", ".index.json"):
        with open(tmp_path / f"ref{suffix}", "rb") as f1, open(tmp_path / f"port{suffix}", "rb") as f2:
            assert f1.read() == f2.read()
    back = tsl.read_bundle(str(tmp_path / "ref"), keys=["f32", "u0"])
    assert list(back) == ["f32", "u0"]
    np.testing.assert_array_equal(_np(back["u0"]), arrays["u0"])


def test_torn_and_corrupt_frames_raise_typed_errors(tmp_path):
    path = str(tmp_path / "s.blob")
    store.write_store(path, [("a", torch.ones(64)), ("b", torch.zeros(64))], level=6)
    s = store.OptionalStore(path)
    e = s.entries["b"]
    with pytest.raises(store.CorruptFrameError, match="'b'"):
        s.decode("b", b"\x00" * e.csize)
    s.close()
    with open(path, "r+b") as f:
        f.truncate(e.offset + 1)
    with pytest.raises(store.StoreSkewError):
        store.OptionalStore(path)


def test_short_preads_are_resumed(tmp_path, monkeypatch):
    """One pread may return fewer bytes than asked (Linux caps a call near
    2 GiB, below a coalesced run of full-width expert frames); reads resume
    until the frame is whole."""
    units = _units(ml_dtypes.bfloat16)
    path = str(tmp_path / "s.blob")
    store.write_store(path, [(k, tensor_from_numpy(a, "cpu")) for k, a in units], level=1)
    real = os.preadv

    def short(fd, buffers, offset):
        return real(fd, [memoryview(buffers[0])[:7]], offset)

    s = store.OptionalStore(path)
    monkeypatch.setattr(os, "preadv", short)
    many = s.read_raw_many([k for k, _ in units])
    for key, arr in units:
        np.testing.assert_array_equal(_np(s.decode(key, many[key])), arr)


@pytest.mark.parametrize("gap", [0, 1, 4096])
def test_vectored_reads_count_like_the_reference(tmp_path, gap):
    """``read_raw_many(gap_threshold=, stats=)``: the same frames, preads,
    coalesced and gap bytes as the reference's on a blob it wrote (with a
    hole between frames: one key is left out of the read); ``gap=0`` is one
    pread per frame."""
    units = _units(np.float32) * 3
    units = [(f"u{i}", a) for i, (_, a) in enumerate(units)]
    path = str(tmp_path / "v.blob")
    ref_store.write_store(path, units)
    keys = [k for k, _ in units if k != "u5"]
    mine, ref = store.OptionalStore(path), ref_store.OptionalStore(path)
    try:
        rs, ref_rs = store.ReadStats(), ref_store.ReadStats()
        got = mine.read_raw_many(reversed(keys), gap_threshold=gap, stats=rs)
        want = ref.read_raw_many(keys, gap_threshold=gap, stats=ref_rs)
        assert {k: bytes(v) for k, v in got.items()} == want
        assert (rs.preads, rs.frames, rs.coalesced_bytes, rs.gap_bytes) == \
            (ref_rs.preads, ref_rs.frames, ref_rs.coalesced_bytes, ref_rs.gap_bytes)
        assert rs.frames == len(keys) and (rs.preads == len(keys)) == (gap == 0)
        one = store.ReadStats()
        assert bytes(mine.read_raw("u3", stats=one)) == want["u3"] and (one.preads, one.frames) == (1, 1)
    finally:
        mine.close()
        ref.close()
