"""The port's native host IO on the CPU: the streaming sensor runtime
(native/runtime.cpp, built into the port's _build/) against the JAX
package's StreamSync and native runtime, and the port's repaired
prefetching PNG loader (vins_tpu_torch/csrc/host/dataloader.cpp) against
the port's Python decoder, in order and exactly, under a stress of many
loaders with more workers than frames in flight. No test here drives
the JAX package's native/libvinsloader.so prefetcher. The libraries
build with g++ at first use; a test skips only where g++ or zlib's
headers are absent."""
import os
import struct
import threading
import zlib

import numpy as np
import pytest
import torch

from vins_tpu.io import native_runtime as j_nr

from vins_tpu_torch import default_config
from vins_tpu_torch.config import ImuConfig
from vins_tpu_torch.core.preintegration import propagate
from vins_tpu_torch.io import euroc, native_build, native_loader
from vins_tpu_torch.io import native_runtime as t_nr

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _require(name: str) -> None:
    """Build the library or skip where the toolchain is absent."""
    try:
        native_build.build(name)
    except native_build.BuildError as e:
        msg = str(e)
        if "g++ not found" in msg:
            pytest.skip("no g++: the native host libraries cannot be built")
        if "zlib.h" in msg:
            pytest.skip("no zlib headers: the native loader cannot be built")
        raise


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _feed(sync, t_end=1.0, accel_hz=100.0, gyro_hz=97.0, img_hz=10.0):
    """tests/test_native_runtime.py's event stream (deterministic: its
    seed draws nothing): accel at 100 Hz, gyro at 97 Hz, images at 10 Hz,
    in time order; every ready chunk polled."""
    t_a = np.arange(0.0, t_end, 1.0 / accel_hz)
    t_g = np.arange(0.0005, t_end, 1.0 / gyro_hz)
    t_i = np.arange(0.105, t_end - 0.05, 1.0 / img_hz)
    acc = np.stack([np.sin(3 * t_a), np.cos(2 * t_a), 9.8 + 0.1 * t_a], 1)
    gyr = np.stack([0.1 * t_g, np.cos(t_g), np.sin(t_g)], 1)
    events = ([("a", t, acc[i]) for i, t in enumerate(t_a)]
              + [("g", t, gyr[i]) for i, t in enumerate(t_g)]
              + [("i", t, None) for t in t_i])
    events.sort(key=lambda e: e[1])
    out = []
    img_id = 0
    for kind, t, v in events:
        if kind == "a":
            sync.push_accel(t, v)
        elif kind == "g":
            sync.push_gyro(t, v)
        else:
            sync.push_image(t, img_id)
            img_id += 1
        while True:
            r = sync.poll()
            if r is None:
                break
            out.append(r)
    return out


def _assert_same_stream(out_a, out_b):
    """tests/test_native_runtime.py::test_native_matches_python's bounds."""
    assert len(out_a) == len(out_b) >= 7
    for (ia, ta, ca), (ib, tb, cb) in zip(out_a, out_b):
        assert ia == ib
        np.testing.assert_allclose(ta, tb, atol=1e-12)
        np.testing.assert_allclose(_np(ca.dt), _np(cb.dt), atol=1e-6)
        np.testing.assert_allclose(_np(ca.acc), _np(cb.acc), atol=1e-5)
        np.testing.assert_allclose(_np(ca.gyr), _np(cb.gyr), atol=1e-5)


def test_native_stream_sync_matches_jax_stream_sync():
    _require("vinsruntime")
    sync = t_nr.NativeStreamSync(max_per_edge=32, device="cpu")
    out = _feed(sync)
    assert all(c.dt.device.type == "cpu" and c.acc.shape == (32, 3)
               for _, _, c in out)
    _assert_same_stream(out, _feed(j_nr.StreamSync(max_per_edge=32)))
    # The port's pure-Python StreamSync, re-exported beside it, agrees too.
    _assert_same_stream(out, _feed(t_nr.StreamSync(max_per_edge=32,
                                                   device="cpu")))
    sync.close()


def test_native_stream_sync_matches_jax_native():
    """Against the JAX package's own ctypes runtime, where its shared
    library loads as it is (a stale one would be rebuilt under native/,
    which this test must not cause)."""
    _require("vinsruntime")
    so = os.path.join(_REPO, "native", "libvinsruntime.so")
    src = os.path.join(_REPO, "native", "runtime.cpp")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        pytest.skip("native/libvinsruntime.so is older than its source: "
                    "loading it would rebuild it under native/")
    _assert_same_stream(
        _feed(t_nr.NativeStreamSync(max_per_edge=32, device="cpu")),
        _feed(j_nr.NativeStreamSync(max_per_edge=32)))


def test_native_overflow_conserves_dt():
    """More samples than chunk rows: the overflow folds into the last row
    and the chunk's dt still sums to the image interval, in the native
    and the Python runtime alike."""
    _require("vinsruntime")
    for sync in (t_nr.NativeStreamSync(max_per_edge=6, device="cpu"),
                 t_nr.StreamSync(max_per_edge=6, device="cpu")):
        for k in range(120):
            t = k * 0.01
            assert sync.push_accel(t, (0.0, 0.0, 9.8))
            assert sync.push_gyro(t + 0.0001, (0.0, 0.0, 0.1))
        sync.push_image(0.5, 0)
        sync.push_image(0.8, 1)
        assert sync.pending() == 2
        r0, r1 = sync.poll(), sync.poll()
        assert r0 is not None and r1 is not None and sync.poll() is None
        assert (r0[0], r1[0]) == (0, 1)
        np.testing.assert_allclose(float(r1[2].dt.sum()), 0.3, atol=1e-5)
        assert not sync.push_accel(0.5, (0.0, 0.0, 9.8))   # out of order


def test_stream_chunks_feed_preintegration():
    """Chunks of constant motion integrate to the closed form (as
    tests/test_native_runtime.py's test), through make_stream_sync."""
    _require("vinsruntime")
    sync = t_nr.make_stream_sync(32, device="cpu")
    assert isinstance(sync, t_nr.NativeStreamSync)
    a_const = np.array([0.2, -0.1, 9.9])
    for k in range(200):
        t = k * 0.005
        sync.push_accel(t, a_const)
        sync.push_gyro(t + 1e-4, (0.0, 0.0, 0.0))
    for i, t in enumerate([0.3, 0.5, 0.7]):
        sync.push_image(t, i)
    chunks = []
    while True:
        r = sync.poll()
        if r is None:
            break
        chunks.append(r[2])
    assert len(chunks) == 3
    z = torch.zeros(3)
    pre = propagate(chunks[1], z, z, ImuConfig())
    np.testing.assert_allclose(float(pre.sum_dt), 0.2, atol=1e-4)
    np.testing.assert_allclose(pre.dp.numpy(), 0.5 * a_const * 0.2 ** 2,
                               rtol=2e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# The prefetching loader
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ft, line, prev):
    """PNG filter `ft` (0-4) applied to one row of 8-bit gray."""
    out = bytearray(len(line))
    for x in range(len(line)):
        a = int(line[x - 1]) if x else 0
        b = int(prev[x])
        c = int(prev[x - 1]) if x else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
        out[x] = (int(line[x]) - pred) & 0xFF
    return bytes(out)


def _write_gray_png(path, arr, filters):
    """An 8-bit grayscale PNG whose row y uses filter filters[y]."""
    H, W = arr.shape
    prev = np.zeros(W, np.uint8)
    raw = b""
    for y in range(H):
        ft = int(filters[y])
        raw += bytes([ft]) + _filter_row(ft, arr[y], prev)
        prev = arr[y]

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def _pngs(tmp_path, n, H=24, W=32, seed=2):
    """n seeded PNGs using every filter type; returns (paths, arrays)."""
    rng = np.random.default_rng(seed)
    paths, arrs = [], []
    for k in range(n):
        arr = rng.integers(0, 256, (H, W), dtype=np.uint8)
        p = str(tmp_path / f"{k:03d}.png")
        _write_gray_png(p, arr, rng.integers(0, 5, H))
        paths.append(p)
        arrs.append(arr.astype(np.float32) / 255.0)
    return paths, arrs


def test_decode_png_native_matches_python_decoder(tmp_path):
    """Every filter type decodes exactly as the port's Python decoder (and
    the source array); a file that is not the requested size raises."""
    _require("vinsloader")
    paths, arrs = _pngs(tmp_path, 4)
    for p, a in zip(paths, arrs):
        got = native_loader.decode_png_native(p, 32, 24)
        np.testing.assert_array_equal(got, euroc._decode_png_gray8(p))
        np.testing.assert_array_equal(got, a)
    with pytest.raises(IOError):
        native_loader.decode_png_native(paths[0], 33, 24)


def test_prefetcher_in_order_and_exact_under_stress(tmp_path):
    """20 loaders over 24 frames at once, 4 workers and queue_cap = 1 each
    (the setting that starved the original loader's in-order delivery):
    every loader drained in a daemon thread joined within 30 s, every
    frame in order and equal to the Python decoder's."""
    _require("vinsloader")
    paths, _ = _pngs(tmp_path, 24, seed=5)
    expect = [euroc._decode_png_gray8(p) for p in paths]
    results = [None] * 20

    def drain(i):
        loader = native_loader.PrefetchingImageLoader(
            paths, 32, 24, n_workers=4, queue_cap=1)
        try:
            results[i] = list(loader)
        finally:
            loader.close()

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(20)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not any(t.is_alive() for t in threads), "a prefetcher hung"
    for got in results:
        assert got is not None and len(got) == 24
        for g, e in zip(got, expect):
            np.testing.assert_array_equal(g, e)


def test_native_euroc_loader_matches_align_measurements(tmp_path):
    """NativeEurocLoader's pairs against align_measurements and
    load_gray_png on a small ASL tree: the same chunks on the device, the
    same frames."""
    _require("vinsloader")
    import dataclasses

    H, W, n = 24, 32, 9
    cam_dir = tmp_path / "mav0" / "cam0" / "data"
    imu_dir = tmp_path / "mav0" / "imu0"
    cam_dir.mkdir(parents=True)
    imu_dir.mkdir(parents=True)
    paths, _ = _pngs(cam_dir, n, H, W, seed=8)
    cam_ns = (np.arange(n) * 50_000_000 + 1_000_000_000).astype(np.int64)
    with open(tmp_path / "mav0" / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t, p in zip(cam_ns, paths):
            f.write(f"{t},{os.path.basename(p)}\n")
    rng = np.random.default_rng(9)
    imu_ns = np.arange(cam_ns[0] - 20_000_000, cam_ns[-1] + 10_000_000,
                       5_000_000)
    with open(imu_dir / "data.csv", "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        for t in imu_ns:
            v = rng.normal(0, 1, 6)
            f.write(f"{t}," + ",".join(f"{x:.6f}" for x in v) + "\n")
    cfg = default_config()
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, width=W, height=H))
    data = euroc.load_euroc(str(tmp_path))
    loader = native_loader.NativeEurocLoader(data, cfg, start=1, count=7,
                                             n_workers=3, device="cpu")
    got = list(loader)
    loader.close()
    ref = list(euroc.align_measurements(data, cfg, start=1, count=7,
                                        device="cpu"))
    assert len(got) == len(ref) == 6
    for (f, img), r in zip(got, ref):
        assert f.t == r.t and f.image_path == r.image_path
        for a, b in zip(f.chunk, r.chunk):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(img, euroc.load_gray_png(r.image_path))
