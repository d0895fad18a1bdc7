"""The BRIEF check of a lockstep's keyframe DB against the reference
(ROADMAP, "Departures on purpose": BRIEF words at drifted keypoints),
shared by tests/test_torch_interactive_revisit.py and
tests/test_torch_interactive_loop.py: record_inserts records each
side's keyframe rows, and check_brief holds the port's stored keypoints
and words to the reference's as far as two float32 systems can agree.
"""
import numpy as np
import pytest
import torch

from vins_tpu_torch.ops import brief as t_brief
from vins_tpu_torch.ops import image as t_image

# check_brief's bounds: the two packages' stored keypoints may lie
# KP_TOL px apart (measured in the revisit lockstep: at most 1.07e-4 px,
# in the three rows inserted after its carry), and a bit whose float64
# margin lies within ULP_BOUND float32 ulps of the pair's larger tap may
# take either value (measured on the revisit lockstep's kept keypoints
# by tools/torch_brief_margins.py: the port's float32 margin lies at
# most 4.2 ulp from the float64 one, the reference's 23.3 ulp, since its
# CPU branch rounds each tap's position to float32 on its own where the
# port, as the TPU branch, reads every tap at the fraction of one patch
# corner).
KP_TOL = 1e-3
ULP_BOUND = 32.0
# The faults assert_caught plants, each of which check_brief must catch.
FAULTS = ("port_word_flipped", "reference_word_flipped",
          "port_keypoint_shifted")


def record_inserts(lc, frame, imgs, rows):
    """Record in rows, insert by insert, (DB row, frame) of every keyframe
    the loop closer lc inserts (frame[0]: the frame being processed),
    holding the image it was given to the scene's raw frame."""
    add = lc.add_keyframe

    def on_add(img, *args, **kwargs):
        np.testing.assert_array_equal(np.asarray(img), imgs[frame[0]])
        idx = add(img, *args, **kwargs)
        rows.append((int(idx), frame[0]))
        return idx

    lc.add_keyframe = on_add


def blur64(raw: np.ndarray) -> np.ndarray:
    """The BRIEF blur of raw [H, W] in float64: the 5 taps of
    image.gaussian_taps(2.0) (float32 values, as both packages hold
    them), reflect-101, rows then columns."""
    taps = np.asarray(t_image.gaussian_taps(2.0), np.float64)
    out = np.asarray(raw, np.float64)
    for axis in (0, 1):
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for t, w in enumerate(taps):
            j = np.arange(n) + t - len(taps) // 2
            j = np.where(j < 0, -j, j)
            j = np.where(j >= n, 2 * n - 2 - j, j)
            acc += w * np.take(out, j, axis=axis)
        out = acc
    return out


def _bilinear64(img, x, y):
    """Bilinear samples of img at (x, y), each point clamped inside the
    frame (no inserted keypoint's pair comes near a border: insert keeps
    keypoints PATCH_HALF + 4 px inside it; unused slots hold any value)."""
    H, W = img.shape
    x = np.clip(np.nan_to_num(x), 0.0, W - 1.001)
    y = np.clip(np.nan_to_num(y), 0.0, H - 1.001)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def margins64(blur: np.ndarray, pts: np.ndarray):
    """([N, 256] float64 margin ib - ia of every pattern pair, where bit
    k is ib > ia, at keypoints pts [N, 2] (pixel x, y) of the float64 blur;
    [N, 256] the float32 ulp of the pair's larger tap)."""
    pat = t_brief.make_pattern().astype(np.float64)
    x = pts[:, 0].astype(np.float64)[:, None]
    y = pts[:, 1].astype(np.float64)[:, None]
    ia = _bilinear64(blur, x + pat[:, 0], y + pat[:, 1])
    ib = _bilinear64(blur, x + pat[:, 2], y + pat[:, 3])
    top = np.maximum(np.abs(ia), np.abs(ib)).astype(np.float32)
    return ib - ia, np.spacing(top).astype(np.float64)


def _bits(desc: np.ndarray) -> np.ndarray:
    """[N, 8] int32 words -> [N, 256] bool (bit 32 w + j is bit j of
    word w)."""
    w = desc.astype(np.int64)[:, :, None] & 0xFFFFFFFF
    return ((w >> np.arange(32)) & 1).reshape(desc.shape[0], -1) > 0


def check_brief(rec) -> list:
    """A lockstep's keyframe rows against the reference (module
    docstring). rec: db_j and db_t (test_torch_interactive.loop_record of
    each side), rows_j and rows_t (record_inserts), frames (frame -> its
    raw image, for every insert frame). Every row's insert frame is the
    same on both sides, and on every row:
    - each keypoint both keep lies within KP_TOL px of the reference's,
      and a keypoint a side does not keep has words 0 there;
    - the port's extract_brief (its CPU path: the blur and K3's plain
      version) on the row's raw frame at the reference's keypoints gives
      the reference's stored words bit for bit, but for a bit whose
      float64 margin is within ULP_BOUND float32 ulps of the pair's
      larger tap (the two blurs' round-off);
    - every bit where the two stored words differ is one whose float64
      margin changes sign between the two packages' positions, or is
      within ULP_BOUND ulps at either.
    Returns the readout of every differing bit (row, frame, keypoint,
    both positions, pattern pair, each side's bit and float64 margin at
    its own position); raises AssertionError with it if a check fails."""
    dj, dt = rec["db_j"], rec["db_t"]
    n = dj["count"]
    faults, lines = [], []
    frame_of = dict(rec["rows_j"])
    if dict(rec["rows_t"]) != frame_of or sorted(frame_of) != list(range(n)):
        faults.append(f"insert frames differ: reference {rec['rows_j']}, "
                      f"port {rec['rows_t']}")
    both = dj["kp_ok"] & dt["kp_ok"]
    dpx = np.abs(dt["kp_px"] - dj["kp_px"]).max(-1)
    for r, kp in zip(*np.nonzero(both & (dpx > KP_TOL))):
        faults.append(f"row {r} keypoint {kp}: port {dt['kp_px'][r, kp]} px, "
                      f"reference {dj['kp_px'][r, kp]} px, {dpx[r, kp]:.3g} "
                      f"px apart (tolerance {KP_TOL})")
    lines.append(f"stored keypoints both keep: {int(both.sum())}, kept by "
                 f"one side only: {int((dj['kp_ok'] != dt['kp_ok']).sum())}, "
                 f"largest position difference {dpx[both].max():.3g} px")
    for side, d in (("port", dt), ("reference", dj)):
        for r, kp in zip(*np.nonzero(~d["kp_ok"] & np.any(d["desc"] != 0,
                                                          -1))):
            faults.append(f"{side}: row {r} keypoint {kp} is not kept but "
                          f"its words are not 0")

    def pair(r, kp, k, where, px, bit, m, ulp):
        return (f"{where}: row {r} (frame {frame_of.get(r)}) keypoint {kp} "
                f"pair {k} (word {k // 32} bit {k % 32}) at "
                f"({px[0]:.5f}, {px[1]:.5f}) px: bit {int(bit)}, float64 "
                f"margin {m:+.3g} ({abs(m) / ulp:.2f} ulp)")

    for r in range(n):
        raw = rec["frames"][frame_of[r]]
        blur = blur64(raw)
        mj, uj = margins64(blur, dj["kp_px"][r])
        mt, ut = margins64(blur, dt["kp_px"][r])
        bj, bt = _bits(dj["desc"][r]), _bits(dt["desc"][r])
        redo = _bits(t_brief.extract_brief(
            torch.as_tensor(raw), torch.as_tensor(dj["kp_px"][r]),
            torch.as_tensor(dj["kp_ok"][r])).numpy())
        for kp, k in zip(*np.nonzero(redo != bj)):
            line = pair(r, kp, k, "port at the reference's keypoint",
                        dj["kp_px"][r, kp], redo[kp, k], mj[kp, k],
                        uj[kp, k]) + f"; reference bit {int(bj[kp, k])}"
            inside = abs(mj[kp, k]) <= ULP_BOUND * uj[kp, k]
            (lines if inside else faults).append(line)
        for kp, k in zip(*np.nonzero((bt != bj) & both[r][:, None])):
            flips = np.sign(mt[kp, k]) != np.sign(mj[kp, k])
            inside = min(abs(mt[kp, k]) / ut[kp, k],
                         abs(mj[kp, k]) / uj[kp, k]) <= ULP_BOUND
            line = (pair(r, kp, k, "stored words differ; port",
                         dt["kp_px"][r, kp], bt[kp, k], mt[kp, k], ut[kp, k])
                    + "; " + pair(r, kp, k, "reference", dj["kp_px"][r, kp],
                                  bj[kp, k], mj[kp, k], uj[kp, k])
                    + ("; the margin changes sign between the positions"
                       if flips else ""))
            (lines if flips or inside else faults).append(line)
    if faults:
        raise AssertionError("\n".join(["BRIEF check failed:", *faults,
                                         "readout:", *lines]))
    return lines


def assert_caught(rec, fault: str, r: int) -> None:
    """check_brief fails on a copy of rec with one fault planted in DB row
    r, naming that row and the fault, at the first keypoint both sides
    keep and its pattern pair of largest float64 margin: a stored bit of
    the port's words flipped ("port_word_flipped": the stored-word check
    fails, no sign change, far from the ulp bound), the reference's
    ("reference_word_flipped": the re-extraction fails), or the port's
    stored keypoint moved by 0.5 px ("port_keypoint_shifted": the
    position check fails)."""
    rec = dict(rec, db_j=dict(rec["db_j"]), db_t=dict(rec["db_t"]))
    dj, dt = rec["db_j"], rec["db_t"]
    kp = int(np.nonzero(dj["kp_ok"][r] & dt["kp_ok"][r])[0][0])
    blur = blur64(rec["frames"][dict(rec["rows_j"])[r]])
    m, _ = margins64(blur, dj["kp_px"][r, kp:kp + 1])
    k = int(np.argmax(np.abs(m[0])))
    side = dt if fault.startswith("port") else dj
    if fault == "port_keypoint_shifted":
        side["kp_px"] = side["kp_px"].copy()
        side["kp_px"][r, kp, 0] += 0.5
        expect = "px apart"
    else:
        side["desc"] = side["desc"].copy()
        words = side["desc"][r, kp].view(np.uint32)
        words[k // 32] ^= np.uint32(1 << (k % 32))
        expect = ("stored words differ" if fault == "port_word_flipped"
                  else "port at the reference's keypoint")
    with pytest.raises(AssertionError) as err:
        check_brief(rec)
    failed = str(err.value).split("readout:")[0]
    assert expect in failed and f"row {r}" in failed, str(err.value)
