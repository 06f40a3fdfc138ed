"""Loader for the port's native host runtime.

`dsv2n.c` (entropy scan coder, packet assembly, the host in-loop filters
and post-sharpen, HME metric primitives) is compiled with `cc` at first
use into `build/torch_native/` beside the package — and again whenever
the source is newer than the library — and loaded with ctypes. Nothing
is built at import time.
"""
import ctypes as C
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "dsv2n.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "torch_native")
_SO = os.path.join(BUILD_DIR, "libdsv2n.so")
_lock = threading.Lock()
_lib = None


class Seg(C.Structure):
    _fields_ = [("count", C.c_int32), ("damp", C.c_int32)]


def _build():
    """Compile to a temporary name, then rename: a concurrent loader (a
    second test worker) never sees a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (_SO, os.getpid())
    subprocess.run(
        ["cc", "-O3", "-shared", "-fPIC", "-fvisibility=hidden",
         "-o", tmp, _SRC],
        check=True, capture_output=True)
    os.replace(tmp, _SO)


def lib():
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            L = C.CDLL(_SO)
            L.dsvn_scan_enc.restype = C.c_int64
            L.dsvn_scan_enc.argtypes = [
                C.POINTER(C.c_int32), C.c_int64, C.POINTER(Seg), C.c_int,
                C.POINTER(C.c_uint8), C.c_int64]
            L.dsvn_scan_dec.restype = C.c_uint32
            L.dsvn_scan_dec.argtypes = [
                C.POINTER(C.c_uint8), C.c_uint32, C.POINTER(C.c_int32),
                C.POINTER(Seg), C.c_int]
            L.dsvn_zbrle_enc.restype = C.c_int32
            L.dsvn_zbrle_enc.argtypes = [
                C.POINTER(C.c_uint8), C.c_int32, C.c_int,
                C.POINTER(C.c_uint8), C.c_int64]
            L.dsvn_unpack_scan.restype = C.c_int32
            L.dsvn_unpack_scan.argtypes = [
                C.POINTER(C.c_uint8), C.c_int64, C.POINTER(C.c_int32),
                C.c_int64]
            L.dsvn_scan_enc_packed.restype = C.c_int64
            L.dsvn_scan_enc_packed.argtypes = [
                C.POINTER(C.c_uint8), C.c_int64, C.c_int64, C.POINTER(Seg),
                C.c_int, C.POINTER(C.c_uint8), C.c_int64]
            L.dsvn_seg_blob.restype = C.c_int32
            L.dsvn_seg_blob.argtypes = [
                C.POINTER(C.c_int32), C.c_int32, C.POINTER(C.c_uint8),
                C.c_int64]
            L.dsvn_sbim_blob.restype = C.c_int32
            L.dsvn_sbim_blob.argtypes = [
                C.POINTER(C.c_uint8), C.POINTER(C.c_uint16), C.c_int32,
                C.c_int32, C.c_int32, C.POINTER(C.c_uint8), C.c_int64]
            L.dsvn_intra_packets.restype = C.c_int64
            L.dsvn_intra_packets.argtypes = [
                C.c_int32, C.POINTER(C.c_uint8),            # nfr, hdr6
                C.POINTER(C.c_uint32), C.POINTER(C.c_int32),  # fnums, quants
                C.c_int32, C.c_int32, C.c_int32,            # blkw/blkh/qpbits
                C.POINTER(C.c_uint8), C.c_int32,            # statbits, filter
                C.POINTER(C.c_uint8), C.POINTER(C.c_uint8),
                C.POINTER(C.c_uint8), C.c_int32,            # masks, nblk
                C.POINTER(C.c_uint8),                        # packed
                C.POINTER(C.c_int32), C.POINTER(C.c_int8),   # d8ll, d8rest
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),  # offs_ll, offs
                C.POINTER(C.c_int64), C.POINTER(C.c_int32),  # lens, lls
                C.POINTER(Seg), C.POINTER(C.c_int32), C.c_int32,  # segs, eop
                C.c_int32,                                   # blobmode
                C.POINTER(C.c_uint8), C.c_int64,
                C.POINTER(C.c_int64), C.POINTER(C.c_int64)]
            L.dsvn_scan_enc_d8.restype = C.c_int64
            L.dsvn_scan_enc_d8.argtypes = [
                C.POINTER(C.c_int32), C.POINTER(C.c_int8),
                C.POINTER(Seg), C.c_int,
                C.POINTER(C.c_uint8), C.c_int64]
            L.dsvn_expand_rows.restype = C.c_int32
            L.dsvn_expand_rows.argtypes = [
                C.POINTER(C.c_int8), C.POINTER(C.c_int32), C.c_int64,
                C.c_int32, C.POINTER(C.c_int8), C.c_int64]
            L.dsvn_luma_avg_ds.restype = C.c_int32
            L.dsvn_luma_avg_ds.argtypes = [
                C.POINTER(C.c_uint8), C.c_int64, C.c_int32, C.c_int32,
                C.c_int32]
            _setup_hme(L)
            _lib = L
    return _lib


def _i32p(a):
    return a.ctypes.data_as(C.POINTER(C.c_int32))


def _u8p(a):
    return a.ctypes.data_as(C.POINTER(C.c_uint8))


def _i16p(a):
    return a.ctypes.data_as(C.POINTER(C.c_int16))


def _i8p(a):
    return a.ctypes.data_as(C.POINTER(C.c_int8))


def _u32p(a):
    return a.ctypes.data_as(C.POINTER(C.c_uint32))


def _segarr(segments):
    arr = (Seg * len(segments))()
    for i, (count, damp) in enumerate(segments):
        arr[i].count = count
        arr[i].damp = damp
    return arr


_scan_bufs = threading.local()


def _scan_buf(cap):
    st = _scan_bufs
    buf = getattr(st, "buf", None)
    if buf is None or buf.size < cap:
        buf = np.zeros(cap, dtype=np.uint8)
        st.buf = buf
        st.used = 0
    else:
        buf[:min(st.used + 8, buf.size)] = 0
    return buf


def scan_encode(values, segments):
    """Serialize quantized coefficients (scan order) into the HZCC
    bit layout. segments: list of (count, damp) with damp < 0 = NEG-coded.
    Reuses a per-thread output buffer (the bit writer ORs into bytes, so
    only the previously-used prefix needs re-zeroing); the writer is
    bounds-checked and the buffer grows on (pathological) overflow."""
    v = np.ascontiguousarray(values, dtype=np.int32)
    cap = 64 * v.size + (1 << 16)
    while True:
        buf = _scan_buf(cap)
        n = lib().dsvn_scan_enc(_i32p(v), v.size, _segarr(segments),
                                len(segments), _u8p(buf), buf.size)
        if n >= 0:
            break
        _scan_bufs.buf = None
        cap = buf.size * 4
    _scan_bufs.used = int(n)
    return buf[:n].tobytes()


def scan_decode(buf, lim, total, segments):
    """Inverse of scan_encode; returns (values int32, final bit position)."""
    b = np.frombuffer(buf, dtype=np.uint8) if not isinstance(
        buf, np.ndarray) else buf
    b = np.ascontiguousarray(b)
    v = np.zeros(total, dtype=np.int32)
    endbit = lib().dsvn_scan_dec(_u8p(b), lim, _i32p(v), _segarr(segments),
                                 len(segments))
    return v, endbit


def zbrle_encode(bits, inv):
    """ZBRLE-encode a 0/1 array (optionally inverted); returns the blob
    bytes (ref: bs.c:284-318)."""
    b = np.ascontiguousarray(bits, dtype=np.uint8)
    out = np.zeros(4 * b.size + 64, dtype=np.uint8)
    n = lib().dsvn_zbrle_enc(_u8p(b), b.size, int(inv), _u8p(out), out.size)
    if n < 0:
        raise ValueError("zbrle output overflow")
    return out[:n].tobytes()


def scan_encode_packed(seg, total, segments):
    """HZCC scan blob straight from a packed sparse segment (walks only
    the nonzeros). Bit-identical to unpack_scan + scan_encode."""
    b = np.ascontiguousarray(np.frombuffer(seg, dtype=np.uint8)
                             if not isinstance(seg, np.ndarray) else seg)
    cap = 64 * total + (1 << 16)
    grown = False
    while True:
        buf = _scan_buf(cap)
        n = lib().dsvn_scan_enc_packed(_u8p(b), b.size, total,
                                       _segarr(segments), len(segments),
                                       _u8p(buf), buf.size)
        if n >= 0:
            break
        if grown:
            raise ValueError("malformed packed scan segment")
        _scan_bufs.buf = None
        cap = max(buf.size * 4, 8 * total + (1 << 20))
        grown = True
    _scan_bufs.used = int(n)
    return buf[:n].tobytes()


def scan_encode_d8(llband, rest8, segments):
    """scan_encode from the dense split-band transfer format (LL band
    int32 + HF bands int8); bit-identical to scan_encode on the
    recombined array."""
    ll = np.ascontiguousarray(llband, dtype=np.int32)
    r8 = np.ascontiguousarray(rest8, dtype=np.int8)
    cap = 64 * (ll.size + r8.size) + (1 << 16)
    while True:
        buf = _scan_buf(cap)
        n = lib().dsvn_scan_enc_d8(_i32p(ll), _i8p(r8), _segarr(segments),
                                   len(segments), _u8p(buf), buf.size)
        if n >= 0:
            break
        _scan_bufs.buf = None
        cap = buf.size * 4
    _scan_bufs.used = int(n)
    return buf[:n].tobytes()


def expand_rows(packed, rowids, segb, total):
    """Expand segment-compacted HF rows (nonzero rows first + original
    row ids) back into the flat dense int8 layout."""
    pk = np.ascontiguousarray(packed, dtype=np.int8).reshape(-1)
    ri = np.ascontiguousarray(rowids, dtype=np.int32)
    dense = np.empty(total, dtype=np.int8)
    r = lib().dsvn_expand_rows(_i8p(pk), _i32p(ri), ri.size, int(segb),
                               _i8p(dense), total)
    if r != 0:
        raise ValueError("segment row id out of range")
    return dense


def unpack_scan(seg, total):
    """Expand a device-packed sparse-scan segment into the dense scan
    array (int32). Raises on a malformed segment."""
    s = np.ascontiguousarray(np.frombuffer(seg, dtype=np.uint8)
                             if not isinstance(seg, np.ndarray) else seg)
    v = np.zeros(total, dtype=np.int32)
    r = lib().dsvn_unpack_scan(_u8p(s), s.size, _i32p(v), total)
    if r != 0:
        raise ValueError("malformed packed scan segment")
    return v


def seg_blob(vals):
    """Serialize an int32 array as consecutive SEG codes, byte-aligned
    (ref: bs.c:173-189)."""
    v = np.ascontiguousarray(vals, dtype=np.int32)
    out = np.zeros(16 * v.size + 64, dtype=np.uint8)
    n = lib().dsvn_seg_blob(_i32p(v), v.size, _u8p(out), out.size)
    if n < 0:
        raise ValueError("seg blob overflow")
    return out[:n].tobytes()


def _u16p(a):
    return a.ctypes.data_as(C.POINTER(C.c_uint16))


def sbim_blob(submask, dc, mask_all, dc_pred_bit):
    """Sub-block intra mask + DC section (ref: dsv_encoder.c:732-760)."""
    sm = np.ascontiguousarray(submask, dtype=np.uint8)
    d = np.ascontiguousarray(dc, dtype=np.uint16)
    out = np.zeros(3 * sm.size + 64, dtype=np.uint8)
    n = lib().dsvn_sbim_blob(_u8p(sm), _u16p(d), sm.size, int(mask_all),
                             int(dc_pred_bit), _u8p(out), out.size)
    if n < 0:
        raise ValueError("sbim blob overflow")
    return out[:n].tobytes()


def post_process(plane):
    """In-place de-gradient sharpen (ref: bmc.c:340-361)."""
    assert plane.dtype == np.uint8 and plane.flags.c_contiguous
    h, w = plane.shape
    lib().dsvn_post_process(_u8p(plane), w, h, plane.strides[0])


def intra_filter(plane_arr, w, h, stride, blockdata, nbh, nbv, fq, fthresh,
                 lossless, do_filter):
    lib().dsvn_intra_filter(_u8p(plane_arr), w, h, stride, _u8p(blockdata),
                            nbh, nbv, fq, fthresh, int(lossless),
                            int(do_filter))


def luma_filter(plane_arr, w, h, stride, mvx, mvy, mvflags, submask,
                nbh, nbv, blk_w, blk_h, fq, fthresh, lossless, do_filter,
                temporal_mc, inter_sharpen):
    lib().dsvn_luma_filter(_u8p(plane_arr), w, h, stride,
                           _i16p(mvx), _i16p(mvy), _u32p(mvflags),
                           _u8p(submask), nbh, nbv, blk_w, blk_h, fq, fthresh,
                           int(lossless), int(do_filter), int(temporal_mc),
                           int(inter_sharpen))


def chroma_filter(plane_arr, w, h, stride, mvx, mvy, mvflags,
                  nbh, nbv, bw, bh, q, lossless):
    lib().dsvn_chroma_filter(_u8p(plane_arr), w, h, stride,
                             _i16p(mvx), _i16p(mvy), _u32p(mvflags),
                             nbh, nbv, bw, bh, q, int(lossless))


# --- HME metric primitives -------------------------------------------------

_B = 32  # frame border


def _setup_hme(L):
    import ctypes as C
    V = C.c_void_p
    L.dsvn_metr.restype = C.c_uint32
    L.dsvn_metr.argtypes = [V, C.c_int, V, C.c_int] + [C.c_int] * 5
    L.dsvn_umetr.restype = C.c_uint32
    L.dsvn_umetr.argtypes = [V, C.c_int, V, C.c_int] + [C.c_int] * 5
    L.dsvn_sse.restype = C.c_uint32
    L.dsvn_sse.argtypes = [V, C.c_int, V, C.c_int, C.c_int, C.c_int]
    L.dsvn_qpsad.restype = C.c_uint32
    L.dsvn_qpsad.argtypes = [V, C.c_int, V] + [C.c_int] * 5
    L.dsvn_cand_scores.restype = None
    L.dsvn_cand_scores.argtypes = ([V, C.c_int, V, C.c_int]
                                   + [C.c_int] * 6 + [V, V, C.c_int, V])
    L.dsvn_make_qpel_grid.restype = None
    L.dsvn_make_qpel_grid.argtypes = [V, C.c_int, V]
    L.dsvn_err_intra.restype = None
    L.dsvn_err_intra.argtypes = ([V, C.c_int, V, C.c_int]
                                 + [C.c_int] * 7 + [C.c_uint32, V])
    L.dsvn_block_features.restype = None
    L.dsvn_block_features.argtypes = [V, C.c_int, C.c_int, C.c_int, V]
    L.dsvn_mv_cost.restype = C.c_int32
    L.dsvn_mv_cost.argtypes = [V, V] + [C.c_int] * 10
    L.dsvn_movec_pred.restype = None
    L.dsvn_movec_pred.argtypes = [V, V, C.c_int, C.c_int, C.c_int, V]
    L.dsvn_neighbordif2.restype = None
    L.dsvn_neighbordif2.argtypes = [V, V, V, C.c_int, C.c_int, C.c_int, V]


def pptr(arr, x, y):
    """Address of bordered plane arr at visible coords (x, y)."""
    return (arr.__array_interface__["data"][0]
            + arr.shape[1] * (_B + y) + (_B + x))


def aptr(arr):
    return arr.__array_interface__["data"][0]


def metr(a, ax, ay, b, bx, by, w, h, psy):
    return lib().dsvn_metr(pptr(a, ax, ay), a.shape[1], pptr(b, bx, by),
                           b.shape[1], w, h, psy[0], psy[1], psy[2])


def umetr(a, ax, ay, b, bx, by, w, h, psy):
    return lib().dsvn_umetr(pptr(a, ax, ay), a.shape[1], pptr(b, bx, by),
                            b.shape[1], w, h, psy[0], psy[1], psy[2])


def sse(a, ax, ay, b, bx, by, w, h):
    return lib().dsvn_sse(pptr(a, ax, ay), a.shape[1], pptr(b, bx, by),
                          b.shape[1], w, h)


def cand_scores(a, ax, ay, b, bx, by, w, h, level, psy, dxs, dys):
    n = len(dxs)
    dxa = np.asarray(dxs, dtype=np.int32)
    dya = np.asarray(dys, dtype=np.int32)
    out = np.zeros(n, dtype=np.uint32)
    lib().dsvn_cand_scores(pptr(a, ax, ay), a.shape[1], pptr(b, bx, by),
                           b.shape[1], w, h, level, psy[0], psy[1], psy[2],
                           aptr(dxa), aptr(dya), n, aptr(out))
    return out


def make_qpel_grid(ref, x, y):
    """68x68 probe grid; (x, y) = probe origin minus (1, 1) pre-offset
    handled by the caller (pass the window's top-left visible coords)."""
    q = np.zeros((68, 68), dtype=np.uint8)
    lib().dsvn_make_qpel_grid(pptr(ref, x, y), ref.shape[1], aptr(q))
    return q


def qpsad(a, ax, ay, q, t0, t1, psy):
    return lib().dsvn_qpsad(pptr(a, ax, ay), a.shape[1], aptr(q),
                            t0, t1, psy[0], psy[1], psy[2])


def err_intra(a, ax, ay, b, bx, by, avg_sb, avg_src, w, h, psy, ratio):
    out = np.zeros(3, dtype=np.uint32)
    lib().dsvn_err_intra(pptr(a, ax, ay), a.shape[1], pptr(b, bx, by),
                         b.shape[1], avg_sb, avg_src, w, h,
                         psy[0], psy[1], psy[2], ratio, aptr(out))
    return int(out[0]), int(out[1]), int(out[2])


def block_features(a, x, y, w, h):
    """(detail, avg, var, tex, qtex, hvar, npeaks)."""
    out = np.zeros(7, dtype=np.int32)
    lib().dsvn_block_features(pptr(a, x, y), a.shape[1], w, h, aptr(out))
    return out


def mv_cost(mvx, mvy, nbh, blk_w, blk_h, vid_w, vid_h, i, j, mx, my, q, sqr):
    return lib().dsvn_mv_cost(aptr(mvx), aptr(mvy), nbh, blk_w, blk_h,
                              vid_w, vid_h, i, j, mx, my, q, sqr)


def movec_pred(mvx, mvy, nbh, x, y):
    out = np.zeros(2, dtype=np.int32)
    lib().dsvn_movec_pred(aptr(mvx), aptr(mvy), nbh, x, y, aptr(out))
    return int(out[0]), int(out[1])


def neighbordif2(mvx, mvy, skip_u8, nbh, x, y):
    out = np.zeros(2, dtype=np.int32)
    lib().dsvn_neighbordif2(aptr(mvx), aptr(mvy), aptr(skip_u8), nbh, x, y,
                            aptr(out))
    return int(out[0]), int(out[1])


_pkt_bufs = threading.local()


def _pkt_buf(cap):
    """Reusable zeroed output buffer for packet assembly (the bit writer
    ORs into bytes, so only the previously-used prefix needs clearing)."""
    st = _pkt_bufs
    buf = getattr(st, "buf", None)
    if buf is None or buf.size < cap:
        buf = np.zeros(cap, dtype=np.uint8)
        st.buf = buf
        st.used = 0
    else:
        buf[:min(st.used + 8, buf.size)] = 0
    return buf


def intra_packets(hdr6, fnums, quants, blkw_code, blkh_code, qp_bits,
                  statbits, intra_filter, stable_bits, ring_bits,
                  maint_bits, packed, offs, lens, lls, segments3, eop,
                  nnz_total, dense8=None, offs_ll=None, blob=False):
    """Assemble complete intra picture packets for a frame batch straight
    from device-packed plane segments OR (dense8 != None) from the dense
    split-band format: dense8 = (llbuf int32, restbuf int8) with offs_ll /
    offs holding element offsets. Returns a list of nfr bytes objects
    (link offsets still zero; the session patches them).

    statbits: (nfr, 3) uint8 {stable, maintain, ringing} markers.
    stable/ring/maint_bits: (nfr, nblk) uint8. packed: flat uint8 buffer
    with offs/lens/lls indexed [c*nfr + fi]. segments3: per-plane
    (count, damp) tables. nnz_total: total nonzero coefficients across the
    batch (sizes the output buffer)."""
    nfr = len(fnums)
    nblk = stable_bits.shape[1]
    segs = []
    seg_n = np.zeros(3, dtype=np.int32)
    for c, tab in enumerate(segments3):
        seg_n[c] = len(tab)
        segs.extend(tab)
    sarr = _segarr(segs)
    fn = np.ascontiguousarray(fnums, dtype=np.uint32)
    qs = np.ascontiguousarray(quants, dtype=np.int32)
    st = np.ascontiguousarray(statbits, dtype=np.uint8)
    sb = np.ascontiguousarray(stable_bits, dtype=np.uint8)
    rb = np.ascontiguousarray(ring_bits, dtype=np.uint8)
    mb = np.ascontiguousarray(maint_bits, dtype=np.uint8)
    if dense8 is not None:
        llb = np.ascontiguousarray(dense8[0], dtype=np.int32)
        r8b = np.ascontiguousarray(dense8[1], dtype=np.int8)
        llp, r8p = _i32p(llb), _i8p(r8b)
        ofll = np.ascontiguousarray(offs_ll, dtype=np.int64)
        pk = np.zeros(1, dtype=np.uint8)
    else:
        llp = r8p = None
        ofll = np.zeros(1, dtype=np.int64)
        pk = np.ascontiguousarray(packed, dtype=np.uint8)
    of = np.ascontiguousarray(offs, dtype=np.int64)
    ln = np.ascontiguousarray(lens, dtype=np.int64)
    ll = np.ascontiguousarray(lls, dtype=np.int32)
    h6 = np.frombuffer(bytes(hdr6), dtype=np.uint8)
    # worst case ~15 bytes per coded coefficient + per-frame header/mask
    # overhead; generously padded so a single pass always fits
    cap = 64 + nfr * (3 * nblk + 1024) + 16 * int(nnz_total)
    buf = _pkt_buf(cap)
    po = np.zeros(nfr, dtype=np.int64)
    pl = np.zeros(nfr, dtype=np.int64)
    n = lib().dsvn_intra_packets(
        nfr, _u8p(h6), _u32p(fn), _i32p(qs),
        int(blkw_code), int(blkh_code), int(qp_bits),
        _u8p(st), int(intra_filter),
        _u8p(sb), _u8p(rb), _u8p(mb), int(nblk),
        _u8p(pk), llp, r8p,
        ofll.ctypes.data_as(C.POINTER(C.c_int64)),
        of.ctypes.data_as(C.POINTER(C.c_int64)),
        ln.ctypes.data_as(C.POINTER(C.c_int64)), _i32p(ll),
        sarr, _i32p(seg_n), int(eop), int(blob),
        _u8p(buf), buf.size,
        po.ctypes.data_as(C.POINTER(C.c_int64)),
        pl.ctypes.data_as(C.POINTER(C.c_int64)))
    if n < 0:
        raise ValueError("intra packet assembly failed (overflow or "
                         "malformed packed segment)")
    _pkt_bufs.used = int(n)
    return [buf[po[i]:po[i] + pl[i]].tobytes() for i in range(nfr)]


def luma_avg_ds(view, levels):
    """Average luma of the coarsest pyramid level, computed by repeated
    2x box downsampling (all intermediate dims must be even — caller
    checks) without materializing the pyramid."""
    h, w = view.shape
    assert view.strides[1] == 1
    r = lib().dsvn_luma_avg_ds(_u8p(view), view.strides[0], w, h,
                               int(levels))
    if r < 0:
        raise MemoryError("luma_avg_ds")
    return int(r)
