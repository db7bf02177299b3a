"""The port's native host data path (eventclip_tpu_torch/native) vs its
numpy path and vs the JAX package's native library.

Bit parity is the contract, as tests/test_native.py holds the JAX package:
the fused C++ pass must reproduce data/host_ops.py's center / tflip /
shift / hflip chain, the window packing and the N-ImageNet record decode
exactly, on both routes of the port and against the JAX package's own
library on the same streams. The C++ source is the JAX package's, copied:
a test pins the copy byte-identical, so drift is loud.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from eventclip_tpu import native as ref_native
from eventclip_tpu.data import host_ops as ref_host
from eventclip_tpu_torch import native
from eventclip_tpu_torch.data import host_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def force_path(monkeypatch):
    """Switch the host-ops dispatch between numpy and native."""

    def _set(mode: str):
        monkeypatch.setenv("EVENTCLIP_NATIVE",
                           "1" if mode == "native" else "0")
        native.reset_for_tests()

    yield _set
    monkeypatch.delenv("EVENTCLIP_NATIVE", raising=False)
    native.reset_for_tests()


def random_stream(rng, n, H=180, W=240, tmax=0.3):
    return np.stack([
        rng.integers(0, W, n).astype(np.float32),
        rng.integers(0, H, n).astype(np.float32),
        np.sort(rng.random(n).astype(np.float32)) * tmax,
        rng.choice([-1.0, 1.0], n).astype(np.float32),
    ], 1)


def numpy_chain(ev, H, W, center, tflip, dx, dy, hflip):
    out = ev.copy()
    if center:
        out = host_ops.center_events(out, (H, W))
    if tflip:
        out = host_ops.tflip_events(out, p=1.0)
    out = host_ops.shift_events_by(out, dx, dy, (H, W))
    if hflip:
        out = host_ops.hflip_events(out, resolution=(H, W), p=1.0)
    return out


def test_source_is_the_jax_packages_byte_for_byte():
    with open(native.SRC, "rb") as f, open(ref_native.SRC, "rb") as g:
        assert f.read() == g.read()
    assert native.SRC != ref_native.SRC
    assert os.path.dirname(native.LIB) == os.path.join(
        ROOT, "eventclip_tpu_torch", "_build")


@pytest.mark.parametrize("n", [0, 1, 2, 37, 5000])
def test_transform_matches_numpy_chain_and_jax(n):
    """Bit-equal to the numpy chain and to the JAX package's library over
    random flips and shifts (n = 0: an empty stream, shifted and h-flipped;
    the numpy chain can neither centre nor t-flip it)."""
    rng = np.random.default_rng(n)
    H, W = 180, 240
    for _ in range(40):
        ev = random_stream(rng, n, H, W)
        tflip, hflip = bool(rng.random() < 0.5), bool(rng.random() < 0.5)
        tflip = tflip and n > 0  # the numpy tflip reads the first event
        dx, dy = (int(v) for v in rng.integers(-20, 21, size=2))
        kw = dict(center=n > 0, tflip=tflip, shift=(dx, dy), hflip=hflip)
        want = numpy_chain(ev, H, W, n > 0, tflip, dx, dy, hflip)
        got = native.transform_events(ev, (H, W), **kw)
        assert want.dtype == got.dtype == np.float32
        assert want.shape == got.shape
        assert (want == got).all()
        np.testing.assert_array_equal(
            got, ref_native.transform_events(ev, (H, W), **kw))


def test_transform_center_only_and_input_unmutated():
    ev = random_stream(np.random.default_rng(0), 500)
    before = ev.copy()
    got = native.transform_events(ev, (180, 240), center=True)
    assert (ev == before).all(), "native transform must not mutate its input"
    assert (got == host_ops.center_events(ev.copy(), (180, 240))).all()


def test_transform_can_drop_everything():
    ev = np.tile(np.array([[5.0, 5.0, 0.0, 1.0]], np.float32), (64, 1))
    ev[:, 2] = np.linspace(0, 1, 64)
    got = native.transform_events(ev, (32, 32), shift=(100, 100))
    assert got.shape == (0, 4)


def test_tta_variants_both_paths_and_jax_agree(force_path):
    ev = host_ops.center_events(random_stream(np.random.default_rng(7),
                                              3000), (180, 240))
    force_path("numpy")
    a = host_ops.tta_variants(ev, (180, 240))
    force_path("native")
    b = host_ops.tta_variants(ev, (180, 240))
    c = ref_host.tta_variants(ev, (180, 240))
    assert len(a) == len(b) == len(c) == 4
    for x, y, z in zip(a, b, c):
        assert (x == y).all() and (y == z).all()


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("n,window,views", [
    (50, 100, 3),      # one short window
    (950, 100, 5),     # subsample (9 full + tail > 5 slots)
    (230, 100, 5),     # tail-window rule (rem 30 <= N/2: no tail)
    (260, 100, 5),     # tail-window rule (rem 60 > N/2: tail)
])
def test_gather_windows_both_paths_and_jax_agree(force_path, packed, n,
                                                 window, views):
    ev = random_stream(np.random.default_rng(n), n)
    outs = []
    for mode in ("numpy", "native"):
        force_path(mode)
        outs.append(host_ops.gather_event_windows(
            ev, window, views, rng=np.random.default_rng(1), packed=packed))
    outs.append(ref_host.gather_event_windows(
        ev, window, views, rng=np.random.default_rng(1), packed=packed))
    for w, v in outs[1:]:
        assert w.dtype == outs[0][0].dtype
        np.testing.assert_array_equal(w, outs[0][0])
        np.testing.assert_array_equal(v, outs[0][1])


def test_dataset_items_identical_across_paths_and_jax(force_path, tmp_path):
    """An augmenting N-Caltech101 item (load -> center -> tflip/shift/hflip
    -> window pack) is bit-identical whichever route serves it, and equal
    to the JAX package's item, draws included (draw_augment)."""
    from eventclip_tpu.data.datasets import NCaltech101 as RefNCaltech101
    from eventclip_tpu.data.event_windows import \
        EventWindowDataset as RefEventWindowDataset
    from eventclip_tpu_torch.data.datasets import NCaltech101
    from eventclip_tpu_torch.data.event_windows import EventWindowDataset

    rng = np.random.default_rng(3)
    root = tmp_path / "train"
    for cls in ("a", "b"):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(2):
            np.save(d / f"s{i}.npy", random_stream(rng, 400))

    def snapshot(reader, windows):
        ds = reader(str(root), augmentation=True, seed=0)
        ds.flip_time = True  # every augment branch
        wds = windows(ds, {"N": 120, "split_method": "event_count",
                           "max_imgs": 3}, seed=0)
        return [wds[i] for i in range(len(wds))]

    force_path("numpy")
    a = snapshot(NCaltech101, EventWindowDataset)
    force_path("native")
    native.reset_calls()
    b = snapshot(NCaltech101, EventWindowDataset)
    assert native.CALLS["transform"] >= len(b)
    c = snapshot(RefNCaltech101, RefEventWindowDataset)
    for x, y, z in zip(a, b, c):
        assert x["label"] == y["label"] == z["label"]
        for k in ("windows", "valid_mask"):
            np.testing.assert_array_equal(x[k], y[k])
            np.testing.assert_array_equal(y[k], z[k])


def test_numpy_fallback_when_disabled(force_path):
    force_path("numpy")
    assert not native.available()
    native.reset_calls()
    ev = random_stream(np.random.default_rng(0), 64)
    out = host_ops.prepare_stream(ev, (180, 240))
    assert (out == host_ops.center_events(ev.copy(), (180, 240))).all()
    assert native.decode_struct(np.zeros(4, [("x", "<u2"), ("y", "<u2"),
                                             ("t", "<i8"), ("p", "?")])) \
        is None
    assert dict(native.CALLS) == {}  # nothing went through the library
    with pytest.raises(RuntimeError, match="unavailable"):
        native.transform_events(ev, (180, 240))


def test_calls_are_counted_where_the_library_is_called(force_path):
    force_path("native")
    native.reset_calls()
    ev = random_stream(np.random.default_rng(1), 3000)
    c = host_ops.prepare_stream(ev, (180, 240))
    host_ops.gather_event_windows(c, 1000, 4, packed=True)
    host_ops.tta_variants(c, (180, 240))
    assert dict(native.CALLS) == {"transform": 4, "pack_spans": 1}


def test_build_is_idempotent(tmp_path):
    out = tmp_path / "lib.so"
    native.build(str(out))
    native.build(str(out))
    assert out.exists()


def test_first_use_builds_into_the_build_dir(monkeypatch, tmp_path):
    """No library yet (a fresh checkout): _load makes the build dir and
    builds once."""
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "LIB", str(build_dir / "libevent_ops.so"))
    monkeypatch.delenv("EVENTCLIP_NATIVE", raising=False)
    native.reset_for_tests()
    try:
        assert native.available()
        assert (build_dir / "libevent_ops.so").exists()
    finally:
        native.reset_for_tests()


@pytest.fixture
def private_lib(monkeypatch, tmp_path):
    """A copy of the built library at a path of this test's own, made
    stale (older than the source): other test processes share the real
    one and must never see it stale."""
    import shutil

    monkeypatch.delenv("EVENTCLIP_NATIVE", raising=False)
    native.reset_for_tests()
    assert native.available()
    lib = tmp_path / "libevent_ops.so"
    shutil.copy(native.LIB, lib)
    old = os.path.getmtime(native.SRC) - 10
    os.utime(lib, (old, old))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB", str(lib))
    native.reset_for_tests()
    yield str(lib)
    native.reset_for_tests()


def test_stale_source_triggers_rebuild(private_lib):
    """A library older than event_ops.cpp is rebuilt on load."""
    assert native.available()
    assert os.path.getmtime(private_lib) >= os.path.getmtime(native.SRC)


def test_stale_rebuild_failure_warns(private_lib, monkeypatch):
    """Older than the source and the rebuild fails: the stale library loads
    with a loud warning."""
    def fail(*a, **k):
        raise RuntimeError("native build failed (g++): no compiler")

    monkeypatch.setattr(native, "build", fail)
    with pytest.warns(UserWarning, match="STALE native kernels.*no compiler"):
        assert native.available()  # still loads the old library
    assert os.path.getmtime(private_lib) < os.path.getmtime(native.SRC)


def test_build_failure_falls_back_not_raises(monkeypatch, tmp_path):
    """An unwritable build directory degrades to the numpy path (a missing
    directory stands in: the same OSError from mkstemp): build() raises
    with the reason, _load falls back and load_error() keeps it."""
    target = tmp_path / "no" / "such" / "dir" / "lib.so"
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build(str(target))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "dir"))
    monkeypatch.setattr(native, "LIB", str(tmp_path / "dir" / "lib.so"))
    monkeypatch.setattr(native, "SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.delenv("EVENTCLIP_NATIVE", raising=False)
    native.reset_for_tests()
    try:
        assert not native.available()
        assert "native build failed" in native.load_error()
        assert native.decode_struct(np.zeros(3, [("x", "u2"), ("y", "u2"),
                                                 ("t", "i8"), ("p", "u1")])
                                    ) is None
    finally:
        native.reset_for_tests()


def test_build_failure_carries_the_compiler_error(tmp_path, monkeypatch):
    """The compiler's own error text reaches the caller, so a run that
    needs the library can say why it did not build."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="error"):
        native.build(str(tmp_path / "lib.so"))
    assert not (tmp_path / "lib.so").exists()
    assert os.listdir(tmp_path) == ["bad.cpp"]  # no temporary left


def test_switch_off_names_itself_as_the_reason(force_path):
    force_path("numpy")
    assert not native.available()
    assert "EVENTCLIP_NATIVE=0" in native.load_error()
    force_path("native")
    assert native.available() and native.load_error() is None


def test_threaded_items_match_serial():
    """The ctypes calls run GIL-free on loader threads; concurrent calls
    give the same bytes as serial ones (no shared scratch)."""
    rng = np.random.default_rng(11)
    streams = [random_stream(rng, int(rng.integers(500, 4000)))
               for _ in range(32)]

    def work(i):
        ev = native.transform_events(
            streams[i], (180, 240), center=True, tflip=bool(i % 2),
            shift=(i % 7 - 3, i % 5 - 2), hflip=bool(i % 3 == 0))
        return native.pack_spans(ev, [(0, min(len(ev), 300))], 2, 300,
                                 packed=True)

    serial = [work(i) for i in range(32)]
    with ThreadPoolExecutor(max_workers=8) as ex:
        threaded = list(ex.map(work, range(32)))
    for a, b in zip(serial, threaded):
        assert (a == b).all()


def test_pack_spans_rejects_bad_spans():
    ev = random_stream(np.random.default_rng(0), 100)
    with pytest.raises(ValueError, match="view slots"):
        native.pack_spans(ev, [(0, 50), (50, 100), (0, 100)], 2, 100)
    with pytest.raises(ValueError, match="out of bounds"):
        native.pack_spans(ev, [(0, 200)], 2, 100)  # longer than the window
    with pytest.raises(ValueError, match="out of bounds"):
        native.pack_spans(ev, [(80, 130)], 2, 100)  # past the stream's end
    with pytest.raises(ValueError, match="out of bounds"):
        native.pack_spans(ev, [(-10, 40)], 2, 100)  # negative start


def _reference_npz_chain(ev):
    out = np.stack(
        [ev["x"], ev["y"], ev["t"], ev["p"].astype(np.uint8)], 1
    ).astype(np.float64)
    out[:, 2] /= 1e6
    if out[:, 3].min() >= -0.5:
        out[:, 3][out[:, 3] <= 0.5] = -1
    return out.astype(np.float32)


@pytest.mark.parametrize("dt", [
    [("x", "<u2"), ("y", "<u2"), ("t", "<i8"), ("p", "?")],    # real N-IN
    [("x", "<i4"), ("y", "<i4"), ("t", "<u8"), ("p", "<i1")],  # ±1 int8
    [("x", "<f4"), ("y", "<f8"), ("t", "<f8"), ("p", "<u1")],  # float coords
    [("x", "<u2"), ("y", "<u2"), ("t", "<i4"), ("p", "<i2")],
])
def test_decode_struct_matches_reference_chain_and_jax(dt):
    rng = np.random.default_rng(len(dt[3][1]))
    n = 5000
    ev = np.zeros(n, dtype=dt)
    ev["x"] = rng.integers(0, 640, n)
    ev["y"] = rng.integers(0, 480, n)
    tmax = 10 ** 9 if np.dtype(dict(dt)["t"]).itemsize == 8 else 10 ** 6
    ev["t"] = np.sort(rng.integers(0, tmax, n))
    pk = np.dtype(dict(dt)["p"]).kind
    if pk == "b":
        ev["p"] = rng.integers(0, 2, n).astype(bool)
    else:
        ev["p"] = rng.choice([-1, 1] if pk == "i" else [0, 1], n)
    got = native.decode_struct(ev)
    assert got is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, _reference_npz_chain(ev))
    np.testing.assert_array_equal(got, ref_native.decode_struct(ev))


def test_decode_struct_falls_back_outside_envelope():
    evf = np.zeros(8, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<i8"),
                             ("p", "<f4")])
    assert native.decode_struct(evf) is None  # float polarity
    evm = np.zeros(8, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<i8")])
    assert native.decode_struct(evm) is None  # missing field
    assert native.decode_struct(np.zeros((8, 4), np.float32)) is None
    evb = np.zeros(8, dtype=[("x", ">u2"), ("y", "<u2"), ("t", "<i8"),
                             ("p", "?")])
    assert native.decode_struct(evb) is None  # non-native byte order


def test_load_event_npz_native_numpy_and_jax_agree(force_path, tmp_path):
    from eventclip_tpu.data.datasets import load_event_npz as ref_load
    from eventclip_tpu_torch.data.datasets import load_event_npz

    rng = np.random.default_rng(0)
    n = 3000
    ev = np.zeros(n, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<i8"),
                            ("p", "?")])
    ev["x"] = rng.integers(0, 640, n)
    ev["y"] = rng.integers(0, 480, n)
    ev["t"] = np.sort(rng.integers(0, 10 ** 9, n))
    ev["p"] = rng.integers(0, 2, n).astype(bool)
    path = str(tmp_path / "a.npz")
    np.savez(path, event_data=ev)
    empty = str(tmp_path / "empty.npz")
    np.savez(empty, event_data=ev[:0])
    force_path("native")
    native.reset_calls()
    a = load_event_npz(path)
    assert native.CALLS["decode_struct"] == 1
    with pytest.raises(ValueError, match="empty event_data"):
        load_event_npz(empty)
    force_path("numpy")
    b = load_event_npz(path)
    with pytest.raises(ValueError, match="empty event_data"):
        load_event_npz(empty)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, ref_load(path))


def test_empty_stream_center_raises_like_numpy():
    empty = np.zeros((0, 4), np.float32)
    with pytest.raises(ValueError):
        host_ops.center_events(empty.copy(), (180, 240))
    with pytest.raises(ValueError):
        native.transform_events(empty, (180, 240), center=True)
    assert native.transform_events(empty, (180, 240)).shape == (0, 4)


def test_serving_windows_equal_on_both_routes(force_path):
    """The Predictor's host half (copy, polarity remap, content-seeded rng,
    centre, gather) gives the same windows on both routes, TTA too."""
    from eventclip_tpu_torch.serve import Predictor
    from eventclip_tpu_torch.utils.config import load_params

    pred = Predictor(load_params(os.path.join(
        ROOT, "configs/debug/zsclip_tiny_params.py")), ["a", "b"],
        smoke=True, batch_size=2, device="cpu")
    rng = np.random.default_rng(5)
    streams = [random_stream(rng, n) for n in (700, 2600, 9000)]
    streams[1][:, 3] = streams[1][:, 3] > 0  # a 0/1-polarity dump
    for tta in (False, True):
        pred.tta = tta
        force_path("numpy")
        a = pred.gather_windows(streams)
        force_path("native")
        b = pred.gather_windows(streams)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
