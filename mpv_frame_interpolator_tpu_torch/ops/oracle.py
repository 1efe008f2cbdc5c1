"""NumPy oracle: bit-exact transliteration of the HopperRender OpenCL kernels.

The port's own copy of the JAX package's ``ops/oracle.py``, its arithmetic
unchanged (tests/test_torch_oracle.py holds the two equal bit for bit):
``utils/parity.py`` holds the port's kernels against it on the card.  Its
constants are the ones ``ops/flow.py`` states.

This module is the *golden model* for the framework's JAX/Pallas compute path.
It reproduces, in vectorized NumPy, the exact integer/float semantics of the
five reference kernels and their host-side orchestration:

  - calcDeltaSumsKernel.cl        -> calc_delta_sums()
  - determineLowestLayerKernel.cl -> determine_lowest_layer()
  - adjustOffsetArrayKernel.cl    -> adjust_offset_array()
  - blurFlowKernel.cl             -> blur_flow()
  - warpFrameKernel.cl            -> warp_frame()
  - opticalFlowCalc.c:126-203     -> calculate_optical_flow()
  - opticalFlowCalc.c:205-234     -> warp_frames()

Exactness notes (each encodes a C/OpenCL behavior the JAX path must match):
  * unsigned-int accumulations wrap mod 2**32 (atomic_add into uint sums,
    calcDeltaSumsKernel.cl:187).
  * float->uchar conversions truncate toward zero (warpFrameKernel.cl:1-7,
    175-176).
  * OpenCL round() is round-half-away-from-zero (warpFrameKernel.cl:165-168).
  * '>>' on negative ints is an arithmetic shift (warpFrameKernel.cl:155).
  * two different mirror functions: the delta kernel reflects into [0, dim)
    (calcDeltaSumsKernel.cl:84-93), the warp kernel reflects then clamps into
    [1, dim-2] (warpFrameKernel.cl:10-18).

It is intentionally NOT fast; tests use small frames.
"""

from __future__ import annotations

import math

import numpy as np

# config.h:1 (calcDeltaSumsKernel.cl:1)
FIRST_NEIGHBOR_ITERATION = 4
# config.h:2-7
MAX_CALC_RES = 270
MIN_SEARCH_RADIUS = 5
MAX_SEARCH_RADIUS = 16
# blurFlowKernel.cl:2
BLUR_KERNEL_RADIUS = 4

U32 = np.uint32
_MOD32 = np.int64(1) << 32

# Frame output modes (vf_HopperRender.c:21)
WARPED_FRAME_12 = 0
WARPED_FRAME_21 = 1
BLENDED_FRAME = 2
HSV_FLOW = 3
GREY_FLOW = 4
SIDE_BY_SIDE_1 = 5
SIDE_BY_SIDE_2 = 6


def signed_square(v):
    """v*v*sign(v), the quadratic candidate-offset spacing
    (calcDeltaSumsKernel.cl:69-72, adjustOffsetArrayKernel.cl:17)."""
    v = np.asarray(v, np.int64)
    return np.where(v > 0, v * v, -(v * v))


def mirror_inside(pos, dim):
    """Reflect an index into [0, dim): calcDeltaSumsKernel.cl:84-93.

    A single reflection, as in the reference; we additionally clip to the
    valid range so pathological offsets cannot index out of bounds (the
    reference would read out-of-bounds memory there)."""
    pos = np.asarray(pos, np.int64)
    pos = np.where(pos >= dim, dim - (pos - dim + 1), pos)
    pos = np.where(pos < 0, -pos - 1, pos)
    return np.clip(pos, 0, dim - 1)


def mirror_edge2(pos, dim):
    """Reflect+clamp into [1, dim-2]: warpFrameKernel.cl:10-18."""
    pos = np.asarray(pos, np.int64)
    res = pos
    res = np.where(pos >= dim - 1, pos - (pos - (dim - 2)) * 2, res)
    res = np.where(pos < 1, -pos + 1, res)
    return np.clip(res, 1, dim - 2)


def round_half_away(x):
    """OpenCL round(): half away from zero."""
    x = np.asarray(x, np.float64)
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def res_scalar_for(height: int, max_calc_res: int = MAX_CALC_RES) -> int:
    """opticalFlowCalc.c:331-334."""
    rs = 0
    while (height >> rs) > max_calc_res:
        rs += 1
    return rs


def low_dims_for(height: int, stride: int, rs: int):
    """opticalFlowCalc.c:335-336 (frameWidth is the stride)."""
    lw = math.ceil(stride / (2 ** rs))
    lh = math.ceil(height / (2 ** rs))
    return lh, lw


def start_window_size(lh: int, lw: int) -> int:
    """opticalFlowCalc.c:132-143: next power of two of max(lowdim), halved."""
    max_dim = max(lw, lh)
    if max_dim and (max_dim & (max_dim - 1)) == 0:
        window = max_dim
    else:
        while max_dim & (max_dim - 1):
            max_dim &= max_dim - 1
        window = max_dim << 1
    return window // 2


def num_iterations(window_size: int, num_iter_cfg: int = 0) -> int:
    """opticalFlowCalc.c:146-149."""
    it = int(math.log2(window_size)) if window_size > 1 else 0
    if num_iter_cfg == 0 or num_iter_cfg > it:
        return it
    return num_iter_cfg


def _window_sums_u32(vals_u32: np.ndarray, w: int) -> np.ndarray:
    """Sum (L, lh, lw) per-pixel values over w x w windows, wrapping mod 2**32.

    Returns (L, nwin_y, nwin_x). Partial edge windows sum only valid pixels
    (out-of-range threads contribute 0: calcDeltaSumsKernel.cl:59-60)."""
    L, lh, lw = vals_u32.shape
    nwy, nwx = -(-lh // w), -(-lw // w)
    padded = np.zeros((L, nwy * w, nwx * w), np.int64)
    padded[:, :lh, :lw] = vals_u32
    sums = padded.reshape(L, nwy, w, nwx, w).sum(axis=(2, 4)) % _MOD32
    return sums.astype(U32)


def calc_delta_sums(
    f1_y, f1_uv, f2_y, f2_uv,
    offset_array,              # (2, lh, lw) int  (x plane, y plane)
    window_size: int,
    search_radius: int,
    res_scalar: int,
    iteration: int,
    step: int,
    delta_scalar: int,
    neighbor_bias_scalar: int,
):
    """calcDeltaSumsKernel.cl:34-188 + the host-side window summation.

    Returns (search_radius, nwin_y, nwin_x) uint32 window delta sums.
    f*_y is the (dimY, dimX) luma plane, f*_uv the (dimY//2, dimX) interleaved
    chroma plane (NV12 addressing: calcDeltaSumsKernel.cl:96-98)."""
    dim_y, dim_x = f1_y.shape
    _, lh, lw = offset_array.shape
    R = search_radius

    cy, cx = np.mgrid[0:lh, 0:lw]
    scaled_cx = (cx << res_scalar).astype(np.int64)
    scaled_cy = (cy << res_scalar).astype(np.int64)

    ideal_x = offset_array[0].astype(np.int64)
    ideal_y = offset_array[1].astype(np.int64)

    z = np.arange(R, dtype=np.int64)
    rel = (z % R) - R // 2
    adj = signed_square(rel)                      # (R,)
    if step % 2 == 0:
        off_x = ideal_x[None] + adj[:, None, None]
        off_y = np.broadcast_to(ideal_y[None], (R, lh, lw))
    else:
        off_x = np.broadcast_to(ideal_x[None], (R, lh, lw))
        off_y = ideal_y[None] + adj[:, None, None]

    new_cx = mirror_inside(scaled_cx[None] + off_x, dim_x)
    new_cy = mirror_inside(scaled_cy[None] + off_y, dim_y)

    f1_y64 = f1_y.astype(np.int64)
    f2_y64 = f2_y.astype(np.int64)
    f1_uv64 = f1_uv.astype(np.int64)
    f2_uv64 = f2_uv.astype(np.int64)

    y1 = f1_y64[new_cy, new_cx]
    y2 = f2_y64[scaled_cy, scaled_cx][None]
    u1 = f1_uv64[new_cy >> 1, new_cx & ~np.int64(1)]
    u2 = f2_uv64[scaled_cy >> 1, scaled_cx & ~np.int64(1)][None]
    v1 = f1_uv64[new_cy >> 1, (new_cx & ~np.int64(1)) + 1]
    v2 = f2_uv64[scaled_cy >> 1, (scaled_cx & ~np.int64(1)) + 1][None]

    delta = np.abs(y1 - y2) + np.abs(u1 - u2) + np.abs(v1 - v2)
    delta = (delta << delta_scalar) % _MOD32          # uint wrap (cl:99)

    # scaled coords out of frame bounds -> delta forced to 0 (cl:80-81)
    inb = (scaled_cx < dim_x) & (scaled_cy < dim_y)
    delta = np.where(inb[None], delta, 0)

    # offset bias (cl:103-107)
    offset_bias = np.abs(off_x) if step == 0 else np.abs(off_y)

    # neighbor smoothness bias (cl:110-142), active from iteration 4
    neighbor_bias = np.zeros((R, lh, lw), np.int64)
    if iteration >= FIRST_NEIGHBOR_ITERATION:
        w2 = 2 * window_size
        plane = offset_array[0 if step == 0 else 1].astype(np.int64)
        cur = off_x if step == 0 else off_y
        for dx, dy in ((0, w2), (w2, 0), (-w2, 0), (0, -w2)):
            nx = np.clip(cx + dx, 0, lw - 1)
            ny = np.clip(cy + dy, 0, lh - 1)
            n_off = plane[ny, nx][None]
            neighbor_bias += np.abs(n_off - cur)
        neighbor_bias = (neighbor_bias << neighbor_bias_scalar) % _MOD32

    partial = (delta + offset_bias + neighbor_bias) % _MOD32
    return _window_sums_u32(partial, window_size)


def determine_lowest_layer(window_sums_u32: np.ndarray) -> np.ndarray:
    """determineLowestLayerKernel.cl:10-21: first-minimum layer per window."""
    return np.argmin(window_sums_u32, axis=0).astype(np.uint8)


def adjust_offset_array(offset_array, lowest_layer, window_size, search_radius, step):
    """adjustOffsetArrayKernel.cl:9-18: commit the winning quadratic offset."""
    _, lh, lw = offset_array.shape
    R = search_radius
    rel = (lowest_layer.astype(np.int64) % R) - R // 2
    adj = signed_square(rel)
    full = np.repeat(np.repeat(adj, window_size, 0), window_size, 1)[:lh, :lw]
    plane = step & 1
    out = offset_array.copy()
    out[plane] = out[plane] + full.astype(out.dtype)
    return out


def blur_flow(offset_array: np.ndarray) -> np.ndarray:
    """blurFlowKernel.cl: 8x8 box blur (taps [-4,3] in each axis), mirrored
    edges, truncating integer division by 64."""
    r = BLUR_KERNEL_RADIUS
    out = np.empty_like(offset_array)
    for plane in range(offset_array.shape[0]):
        src = offset_array[plane].astype(np.int64)
        # reference mirror (-1 -> 0, dim -> dim-1) == numpy 'symmetric'
        padded = np.pad(src, ((r, r), (r, r)), mode="symmetric")
        lh, lw = src.shape
        acc = np.zeros((lh, lw), np.int64)
        for ky in range(-r, r):
            for kx in range(-r, r):
                acc += padded[r + ky:r + ky + lh, r + kx:r + kx + lw]
        ksz = (2 * r) * (2 * r)
        # C integer division truncates toward zero
        q = np.sign(acc) * (np.abs(acc) // ksz)
        out[plane] = q.astype(offset_array.dtype)
    return out


def calculate_optical_flow(
    f1_y, f1_uv, f2_y, f2_uv,
    search_radius: int,
    res_scalar: int,
    lh: int, lw: int,
    delta_scalar: int = 8,
    neighbor_bias_scalar: int = 6,
    num_iter_cfg: int = 0,
):
    """opticalFlowCalc.c:126-203: full pyramid search + final blur.

    Returns (offset_array, blurred_offset_array), both (2, lh, lw) int16.
    f1 is the OLDER frame, f2 the NEWER (inputFrameArray[0]/[1] after the
    ping-pong swap in opticalFlowCalc.c:96-106)."""
    window = start_window_size(lh, lw)
    iters = num_iterations(window, num_iter_cfg)
    offset = np.zeros((2, lh, lw), np.int16)

    for iteration in range(iters):
        for step in range(2):
            sums = calc_delta_sums(
                f1_y, f1_uv, f2_y, f2_uv, offset,
                window, search_radius, res_scalar, iteration, step,
                delta_scalar, neighbor_bias_scalar)
            lowest = determine_lowest_layer(sums)
            offset = adjust_offset_array(offset, lowest, window, search_radius, step)
        window = max(window >> 1, 1)

    blurred = blur_flow(offset)
    return offset, blurred


# ---------------------------------------------------------------------------
# Warp
# ---------------------------------------------------------------------------

def _clampf(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def _visualize_flow(off_x, off_y, curr_pixel, channel, res_impact):
    """visualizeFlow (warpFrameKernel.cl:21-111), vectorized.

    off_x/off_y: int arrays (already negated by the caller as in cl:178),
    curr_pixel: the blended uchar value, channel: 0=Y 1=U 2=V per pixel,
    res_impact: scalar int."""
    off_x = np.asarray(off_x, np.int64)
    off_y = np.asarray(off_y, np.int64)
    zero_flow = (np.abs(off_x) < 1) & (np.abs(off_y) < 1)

    angle_rad = np.arctan2(off_y.astype(np.float32), off_x.astype(np.float32))
    angle_deg = angle_rad * np.float32(180.0 / math.pi)
    angle_deg = np.where(angle_deg < 0, angle_deg + 360.0, angle_deg)
    angle_deg = np.fmod(angle_deg, 360.0)
    angle_deg = np.where(angle_deg < 0, angle_deg + 360.0, angle_deg)
    hue = angle_deg / np.float32(360.0)

    h_i = (hue * 6.0).astype(np.int64)           # trunc
    f = hue * 6.0 - h_i
    q = 1.0 - f
    f255 = np.trunc(f * 255.0)                   # (uchar)(f*255) truncation
    q255 = np.trunc(q * 255.0)

    sector = h_i % 6
    r = np.select([sector == 0, sector == 1, sector == 2, sector == 3,
                   sector == 4, sector == 5],
                  [255.0, q255, 0.0, 0.0, f255, 255.0], 0.0)
    g = np.select([sector == 0, sector == 1, sector == 2, sector == 3,
                   sector == 4, sector == 5],
                  [f255, 255.0, 255.0, q255, 0.0, 0.0], 0.0)
    b = np.select([sector == 0, sector == 1, sector == 2, sector == 3,
                   sector == 4, sector == 5],
                  [0.0, 0.0, f255, 255.0, 255.0, q255], 0.0)

    mag = (np.abs(off_x) + np.abs(off_y)).astype(np.float32)
    # uchar assignments truncate (cl:98-100)
    r = np.trunc(_clampf(r / 255.0 * mag * res_impact, 0.0, 255.0))
    g = np.trunc(_clampf(g / 255.0 * np.abs(off_y).astype(np.float32) * 2.0 * res_impact, 0.0, 255.0))
    b = np.trunc(_clampf(b / 255.0 * mag * res_impact, 0.0, 255.0))

    r = np.where(zero_flow, 0.0, r)
    g = np.where(zero_flow, 0.0, g)
    b = np.where(zero_flow, 0.0, b)

    curr = np.asarray(curr_pixel, np.int64)
    y_out = (np.trunc(_clampf(r * 0.299 + g * 0.587 + b * 0.114, 0.0, 255.0)).astype(np.int64) >> 1) + (curr >> 1)
    u_out = np.trunc(_clampf(r * -0.168736 + g * -0.331264 + b * 0.5 + 128.0, 0.0, 255.0)).astype(np.int64)
    v_out = np.trunc(_clampf(r * 0.5 + g * -0.418688 + b * -0.081312 + 128.0, 0.0, 255.0)).astype(np.int64)

    return np.select([channel == 0, channel == 1], [y_out, u_out], v_out)


def _apply_levels_y(value, black, white):
    """Black/white level mapping for luma (warpFrameKernel.cl:1-3).

    The reference computes (v-black)/(white-black)*255 in device float32 and
    truncates to uchar.  OpenCL permits 2.5 ulp error on division, and the
    exact results land on integer boundaries (e.g. the identity mapping),
    so the reference's own output is GPU-dependent at those pixels.  This
    framework defines the semantics as the EXACT rational result truncated
    toward zero (levels are integers in the applet protocol,
    vf_HopperRender.c:173-176), evaluated in integer arithmetic -- stable
    across TPU/CPU and within 1 LSB of any conforming OpenCL device."""
    v = np.asarray(value, np.int64)
    k = int(round(black))
    w = int(round(white))
    n = np.maximum((v - k) * 255, 0)
    return np.clip(n // max(w - k, 1), 0, 255)


def _apply_levels_uv(value, white):
    """Chroma level mapping (warpFrameKernel.cl:5-7): exact rational
    truncation of (v-128)/white*255+128 = ((v-128)*255 + 128*white)/white."""
    v = np.asarray(value, np.int64)
    w = max(int(round(white)), 1)
    n = np.maximum((v - 128) * 255 + 128 * w, 0)
    return np.clip(n // w, 0, 255)


def warp_frame(
    f1_y, f1_uv, f2_y, f2_uv,
    blurred_offset,            # (2, lh, lw) int
    blending_scalar: float,
    frame_output_mode: int,
    res_scalar: int,
    actual_width: int,
    black_level: float = 0.0,
    white_level: float = 255.0,
):
    """warpFrameKernel.cl:114-182 for both cz passes (opticalFlowCalc.c:219-232).

    Returns (out_y, out_uv) uint8 planes of the same stride as the inputs;
    samples beyond actual_width are left zero (the reference never writes
    them)."""
    dim_y, dim_x = f1_y.shape
    _, lh, lw = blurred_offset.shape
    fs12 = np.float32(blending_scalar)
    fs21 = np.float32(1.0 - blending_scalar)
    off = blurred_offset.astype(np.int64)

    out_y = np.zeros_like(f1_y)
    out_uv = np.zeros_like(f1_uv)

    for cz in (0, 1):
        rows = dim_y >> cz if cz == 0 else dim_y >> 1
        cy, cx = np.mgrid[0:rows, 0:actual_width]
        cy = cy.astype(np.int64)
        cx = cx.astype(np.int64)
        adj_cy, adj_cx = cy.copy(), cx.copy()

        src1 = (f1_y if cz == 0 else f1_uv).astype(np.int64)
        src2 = (f2_y if cz == 0 else f2_uv).astype(np.int64)
        plane_rows = dim_y if cz == 0 else dim_y >> 1

        forced = np.full(cy.shape, -1, np.int64)  # -1 = not forced

        if frame_output_mode == SIDE_BY_SIDE_1:
            left = cx < (actual_width >> 1)
            forced = np.where(left, src1[cy, cx], forced)
        elif frame_output_mode == SIDE_BY_SIDE_2:
            vo = dim_y >> 2
            in_rows = (cy >= (vo >> cz)) & (cy < ((vo >> cz) + (dim_y >> (1 + cz))))
            in_left = in_rows & (cx < (dim_x >> 1))
            in_right = in_rows & (cx >= (dim_x >> 1)) & (cx < dim_x)
            # left: downscaled source (cl:139)
            ly = np.clip(((cy - (vo >> cz)) << 1), 0, plane_rows - 1)
            lx = np.clip((cx << 1) + ((cx & 1) if cz else 0), 0, dim_x - 1)
            forced = np.where(in_left, src1[ly, lx], forced)
            # outside both: black (cl:145)
            outside = ~in_left & ~in_right
            forced = np.where(outside, 128 if cz else 0, forced)
            # right: remap warp coords (cl:142-143)
            adj_cx = np.where(in_right, (cx - (actual_width >> 1)) << 1, adj_cx)
            adj_cy = np.where(in_right, (cy - (vo >> cz)) << 1, adj_cy)

        # flow lookup (cl:151-156)
        if cz == 0:
            scx = adj_cx >> res_scalar
            scy = adj_cy >> res_scalar
        else:
            scx = (adj_cx >> res_scalar) & ~np.int64(1)
            scy = (adj_cy >> res_scalar) << 1
        scx = np.clip(scx, 0, lw - 1)
        scy = np.clip(scy, 0, lh - 1)
        off_x12 = off[0, scy, scx]
        off_y12 = off[1, scy, scx]
        bscy = np.clip(scy - (off_y12 >> res_scalar), 0, lh - 1)
        bscx = np.clip(scx - (off_x12 >> res_scalar), 0, lw - 1)
        off_x21 = off[0, bscy, bscx]
        off_y21 = off[1, bscy, bscx]

        if frame_output_mode == GREY_FLOW:
            grey = np.minimum((np.abs(off_x12) + np.abs(off_y12)) << 2, 255)
            val = np.where(np.full(cy.shape, cz, np.int64) == 1, 128, grey)
            _write_plane(out_y, out_uv, cz, cy, cx, val)
            continue

        y_dim_cz = (dim_y >> 1) if cz else dim_y
        new_cx12 = mirror_edge2(adj_cx + round_half_away(off_x12.astype(np.float32) * fs12).astype(np.int64), actual_width)
        new_cy12 = mirror_edge2(adj_cy + round_half_away(off_y12.astype(np.float32) * fs12 * (0.5 if cz else 1.0)).astype(np.int64), y_dim_cz)
        new_cx21 = mirror_edge2(adj_cx - round_half_away(off_x21.astype(np.float32) * fs21).astype(np.int64), actual_width)
        new_cy21 = mirror_edge2(adj_cy - round_half_away(off_y21.astype(np.float32) * fs21 * (0.5 if cz else 1.0)).astype(np.int64), y_dim_cz)

        if cz:
            samp_x12 = (new_cx12 & ~np.int64(1)) + (cx & 1)
            samp_x21 = (new_cx21 & ~np.int64(1)) + (cx & 1)
        else:
            samp_x12 = new_cx12
            samp_x21 = new_cx21
        s12 = src1[new_cy12, samp_x12]
        s21 = src2[new_cy21, samp_x21]

        if frame_output_mode == WARPED_FRAME_12:
            val = s12
        elif frame_output_mode == WARPED_FRAME_21:
            val = s21
        else:
            # BlendedFrame / HSVFlow / SideBySide right halves (cl:174-181);
            # fixed-point semantics, see blend_weights()
            w1, w2 = blend_weights(blending_scalar)
            blended = _blend(s12, s21, w1, w2)
            if frame_output_mode == HSV_FLOW:
                res_impact = 4 if res_scalar <= 2 else 1
                channel = np.full(cy.shape, cz, np.int64) + (cx & 1 if cz else 0)
                blended = _visualize_flow(-off_x12, -off_y12, blended, channel, res_impact)
            if cz:
                val = _apply_levels_uv(blended, white_level)
            else:
                val = _apply_levels_y(blended, black_level, white_level)

        val = np.where(forced >= 0, forced, val)
        _write_plane(out_y, out_uv, cz, cy, cx, val)

    return out_y, out_uv


BLEND_FRACTION_BITS = 24


def blend_weights(blending_scalar: float, frac_bits: int = BLEND_FRACTION_BITS):
    """Fixed-point blend weights.

    The reference blends in device float32 (warpFrameKernel.cl:175-176),
    where the compiler is free to contract the mul-add into an FMA --
    making the uchar truncation GPU-dependent at near-integer results.
    The framework defines the blend as exact fixed-point arithmetic:
      out = (s12*(2^24 - T) + s21*T) >> 24,  T = round(t32 * 2^24)
    which is within 1 LSB of any conforming OpenCL device."""
    t32 = np.float32(blending_scalar)
    T = int(np.round(t32 * np.float32(1 << frac_bits)))
    T = min(max(T, 0), 1 << frac_bits)
    return (1 << frac_bits) - T, T


def _blend(s12, s21, w1: int, w2: int, frac_bits: int = BLEND_FRACTION_BITS):
    return (np.asarray(s12, np.int64) * w1 + np.asarray(s21, np.int64) * w2) >> frac_bits


def _write_plane(out_y, out_uv, cz, cy, cx, val):
    if cz == 0:
        out_y[cy, cx] = val.astype(out_y.dtype)
    else:
        out_uv[cy, cx] = val.astype(out_uv.dtype)
