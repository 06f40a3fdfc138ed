#!/usr/bin/env python3
"""Smoke run of the torch port (dsv2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls:
FHD 1920x1080 4:2:0 intra encode at -qp=60 -gop=0, 32 frames, through
parallel/batch.encode_intra_batch; the decode of that stream and of the
committed FHD and CIF P streams through
codec/decoder.decode_stream_chunked; FHD P encode at -qp=60 -gop=8, 8
frames, through cli.make_encoder + encode_frame; the CLIs (`e` at
-gop=0 and -gop=12, `d`) in subprocesses; lockstep CIF P encode (8
streams x 48 frames at -qp=60 -gop=48, BASELINE config 1) through
parallel/dynbatch.encode_streams_lockstep with the gang motion search,
then with groups=2, with kernels 4/5, and in one group of width 3 (the
flushes split into launches of at most 3 lanes); and the gang cost
probe's tool run. Also an FHD high-quality stream (3 frames at -qp=90
-gop=0) encoded by the port and decoded with the dense scan upload, and
20 launches of each of kernels 4-7 (every upper level) on the same
inputs that must agree. Then the inputs dsv2_tpu takes its host chain
for, on the device chain, each against dsv2_tpu's digests: the 8 seeded
byte-flip trials of the committed CIF CRF stream decoded frame by frame
(decode_corrupt), the degenerate geometries 352x16 4:2:0, 16x240 4:2:0
and 64x500 4:1:1 (4 frames at -qp=60 -gop=2) encoded and decoded with
the arena (decode_arena), and the CIF fixture at -qp=60 -gop=6, 8
frames, encoded with the motion search backends "host" and "wave",
aliases of "pallas" (encode_host_hme).
Before that it builds every CUDA kernel of those paths from this
checkout (one nvcc per source, all at once) and holds each against
its plain PyTorch version: the vk chain on random chains, on the
adversarial kinds of tools/torch_port_golden.vk_case (B = 1, 3, 16, 33,
an npad not a multiple of 4, B = 300), on the FHD chunk's scans (timed,
with the share of chunks whose true start met a speculative candidate)
and on P frame 1's luma plane at B = 1 of the FHD P encode and of one
lockstep lane (timed),
the in-loop filter wavefront (three kinds) on seeded random planes at
CIF and FHD geometry and on the planes the FHD decodes feed it (timed,
with the cluster sizes 1, 2, 4 and 8 at FHD luma), and against the
port's native C filters at 3840x2160 luma and intra, at 2560x1440 and
3840x2160 4:4:4 chroma (layouts one CTA cannot hold: clusters) and at
16x16384 4:4:4 (its chroma, which no cluster holds, on the ring in
global memory), the two
motion-search kernels on seeded CIF inputs and on the inputs of FHD P
frames 1 and 2 (level by level), the two gang kernels level by level on
8 seeded CIF lanes and on FHD P frames 1-2 as 2 lanes (against kernels
4/5 and the plain version), and the probe kernels.
Each phase prints one JSON line; any failure raises (non-zero exit).
The last lines are the kernel table, the card's name and power limit,
and the result line {"ok": true, "device": {...}}. Needs CUDA, nvcc and
this repository (no JAX: the golden streams and digests come from
tests/golden/). Writes only under build/.
"""
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
NFRAMES, CHUNK, QP = 32, 16, 60
KERNELS = ("vk_chain", "wavefront_filter", "hme_search", "hme_gang",
           "probe_gang")
P_FRAMES, P_GOP = 8, 8
LS_WARM_FRAMES = 2      # frames per lane of the lockstep warm run
LS_PALLAS_FRAMES = 16   # frames per lane of the lockstep run on kernels 4/5
LS_NARROW = (3, 8)      # (width, frames per lane) of the narrow lockstep run
REPEATS = 20            # launches of kernels 4-7 that must agree
# seeded random filter inputs: (label, (width, height, luma block, chroma
# shift)) — CIF and FHD 4:2:0 geometry
RANDOM_GEOMS = (("cif", (352, 288, 16, 1)), ("fhd", (1920, 1080, 32, 1)))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps launches (CUDA events,
    after one warm-up launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the card's non-tensor 32-bit peak."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / INT_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_port_golden as golden
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec import decoder, devsteps, plane
    from dsv2_tpu_torch.codec.devsteps import blob_cap
    from dsv2_tpu_torch.ops import (_kernels, filters, hme_gang, hme_gpu,
                                    hme_wave, hzcc, scan_pl)
    from dsv2_tpu_torch.parallel import batch, dynbatch
    from dsv2_tpu_torch.tools import probe_gang
    from dsv2_tpu_torch.utils import trace, y4m

    dev = torch.device("cuda")
    gold = golden.load()
    wf = filters.wavefront_filter

    def reset_counts():
        scan_pl.vk_chain.launches = 0
        for k in filters.KINDS:
            wf.launches[k] = 0
        for k in hme_gpu.launches:
            hme_gpu.launches[k] = 0
        for k in probe_gang.launches:
            probe_gang.launches[k] = 0

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build every kernel of the paths from this checkout, in parallel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        libs = dict(zip(KERNELS, ex.map(_kernels.build, KERNELS)))
    for name in KERNELS:
        for e in _kernels.entries(name):
            _kernels.entry(e)
        emit("build", kernel=name, library=os.path.relpath(libs[name], REPO),
             nvcc_seconds=_kernels.build_seconds.get(name))
    emit("build_all", seconds=time.perf_counter() - t0)

    # inputs: the seeded synthetic FHD clip of the benchmark headline
    frames, meta = cli.read_y4m(golden.input_path(golden.FHD))
    assert len(frames) == NFRAMES

    def chunk_scans(fr, m):
        """Quantized scans (per plane (nfr, total) int32 on the card) of
        one chunk, through the batched device step."""
        enc = cli.make_encoder(m, cli.default_enc_opts(qp=QP, gop=0),
                               device=dev)
        ctx = batch._prep_chunk(enc, fr)
        p = ctx["p"]
        xs, bds, qs = batch._chunk_inputs(enc, ctx)
        fn = batch._device_batch_fn(m.width, m.height, m.subsamp, p.blk_w,
                                    p.blk_h, p.lossless, p.do_psy,
                                    ctx["analyze"])
        return ctx["pcfg"], fn(xs[0], xs[1], xs[2], bds, qs)[2]

    # 3. vk kernel vs plain version, bit-exact on every row
    vk_err = 0
    compared = []

    def compare(label, thr, s0, nnz, time_it=False):
        """Kernel vs plain on one call; with the resolve pass's counters
        (the share of chunks whose true start met a speculative candidate,
        the rows re-walked) and, timed, ms against the plain version and
        the bound."""
        nonlocal vk_err
        stats = torch.zeros(5, dtype=torch.int32, device=dev)
        got = scan_pl.vk_chain(thr, s0, nnz, stats)
        torch.cuda.synchronize()
        plain_ms, want = host_ms(lambda: scan_pl.vk_chain_plain(thr, s0,
                                                                nnz))
        err = int((got.long() - want.long()).abs().max())
        vk_err = max(vk_err, err)
        live = int((nnz - s0).clamp(min=0).sum())
        chunks, met, rewalked, _, rows = stats.tolist()
        rec = dict(case=label, npad=thr.shape[0], B=thr.shape[1],
                   live_rows=live, max_abs_err=err, chunks=chunks,
                   met_at_start=met / chunks if chunks else None,
                   rewalked=rewalked, rows_rewalked=rows,
                   plan=_kernels.vk_plan(thr.shape[0] + 3 & ~3,
                                         thr.shape[1]))
        if time_it:
            rec["ms"] = cuda_ms(lambda: scan_pl.vk_chain(thr, s0, nnz), 20)
            rec["plain_ms"] = plain_ms
            # live thr rows read once, every vkpre row written once; a
            # compare, an add and a max per live row
            rec["bound_ms"], rec["bound_by"] = bound(
                4 * live + 4 * thr.numel() + 16 * thr.shape[1], 3 * live)
        compared.append(rec)
        assert err == 0, rec
        return rec

    def on_dev(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    rng = torch.Generator().manual_seed(7)
    for nb in (1, 3, 16):
        npad = 2048 * 64
        thr = torch.randint(0, 60, (npad, nb), generator=rng,
                            dtype=torch.int32)
        thr[torch.rand((npad, nb), generator=rng) < 0.4] = 0
        s0 = torch.randint(0, 4000, (nb,), generator=rng, dtype=torch.int32)
        nnz = torch.maximum(s0, torch.randint(0, npad + 1, (nb,),
                                              generator=rng,
                                              dtype=torch.int32))
        compare("random", thr.to(dev), s0.to(dev), nnz.to(dev))
    # the adversarial kinds (oscillations of both parities, a climb no
    # candidate meets, runs of the clamp, edge ranges); npad not a multiple
    # of 4; more chains than a launch takes
    for kind in golden.VK_KINDS:
        for nb in (1, 3, 16, 33):
            compare("%s_b%d" % (kind, nb), *on_dev(golden.vk_case(
                kind, nb, 8192)))
    compare("random_npad4099_b3", *on_dev(golden.vk_case("random", 3,
                                                         4099)))
    compare("random_b300", *on_dev(golden.vk_case("random", 300, 4096)))
    pcfg, vs = chunk_scans(frames[:CHUNK], meta)
    timed = []
    for c, label in ((1, "fhd_u_chunk"), (2, "fhd_v_chunk"),
                     (0, "fhd_luma_chunk")):
        segs = tuple(hzcc.scan_segments(*pcfg.cdims[c]))
        timed.append(compare(label, *scan_pl.vk_chain_inputs(segs, vs[c]),
                             time_it=True))
    cif_frames, cif_meta = cli.read_y4m(
        golden.input_path("cif352x288_420_12f"))
    cpcfg, cvs = chunk_scans(cif_frames, cif_meta)
    segs = tuple(hzcc.scan_segments(*cpcfg.cdims[0]))
    compare("cif_luma_chunk", *scan_pl.vk_chain_inputs(segs, cvs[0]),
            time_it=True)
    del vs, cvs
    emit("kernel_vs_plain", kernel="vk_chain", max_abs_err=vk_err,
         cases=compared)

    vk_fn = scan_pl.vk_chain

    @contextlib.contextmanager
    def recording_vk(calls):
        """Record (thr, s0, nnz) of each vk chain call with one chain (the
        P paths' planes, in call order: three a frame)."""
        def rec(thr, s0, nnz, stats=None):
            if thr.shape[1] == 1:
                calls.append((thr.clone(), s0.clone(), nnz.clone()))
            return vk_fn(thr, s0, nnz, stats)
        scan_pl.vk_chain = rec
        try:
            yield calls
        finally:
            scan_pl.vk_chain = vk_fn

    # 4. the filter wavefront vs its plain version on seeded random planes
    # at CIF and FHD geometry. The public filters are called on the card
    # with the wavefront recorded; each recorded call is then replayed
    # through the kernel and through the plain version (on the card).
    @contextlib.contextmanager
    def recording(calls):
        """Record (kind, lay, plane, props, scal) of each wavefront call,
        plane copied before the call filters it in place."""
        def rec(kind, lay, plane_, props, scal):
            calls.append((kind, lay, plane_.clone(), props.clone(),
                          scal.clone()))
            return wf(kind, lay, plane_, props, scal)
        filters.wavefront_filter = rec
        try:
            yield calls
        finally:
            filters.wavefront_filter = wf

    wf_err = 0
    wf_cases = []

    def filter_case(label, call, time_it=False):
        """Kernel vs plain on one recorded call, one plane of it."""
        nonlocal wf_err
        kind, lay, src, props, scal = call
        src, props, scal = src[:1], props[:1], scal[:1]
        got = src.clone()
        wf(kind, lay, got, props, scal)
        torch.cuda.synchronize()
        want = src.clone()
        plain_ms, _ = host_ms(lambda: filters.wavefront_filter_plain(
            kind, lay, want, props, scal))
        err = int((got.long() - want.long()).abs().max())
        wf_err = max(wf_err, err)
        rec = dict(case=label, kind=kind, plane=[lay.pw, lay.ph],
                   tile=[lay.tw, lay.th], diagonals=lay.nd, lanes=lay.L,
                   changed_px=int((got != src).sum()), max_abs_err=err)
        plan = filters.wavefront_plan(lay, max_smem=_kernels.max_smem())
        rec.update(cluster=plan.C, smem=plan.smem, threads=plan.threads)
        if time_it:
            work = src.clone()

            def run():
                work.copy_(src)
                wf(kind, lay, work, props, scal)
            rec["ms"] = cuda_ms(run, 5)
            rec["plain_ms"] = plain_ms
            # the plane read once and written once, props read once; three
            # operations per window element of every tile (load, delta,
            # test) as a floor of the work
            rec["bound_ms"], rec["bound_by"] = bound(
                8 * src.numel() + 4 * props.numel(),
                3 * lay.ntx * lay.nty * lay.wh * lay.ww)
        wf_cases.append(rec)
        assert err == 0, rec
        return rec

    g = torch.Generator().manual_seed(11)

    def rnd(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=dtype).to(dev)

    def rnd_plane(w, h):
        """Gradients with mild noise and steps at 8x8 cells (tile energies
        in every filter's working range); the bottom third pure noise."""
        yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        cells = rnd(-24, 25, (-(-h // 8), -(-w // 8)))
        steps = cells.repeat_interleave(8, 0).repeat_interleave(8, 1)
        vis = (xx // 3 + yy // 2 + 64 + steps[:h, :w]
               + rnd(-3, 4, (h, w))).clamp(0, 255).to(torch.uint8)
        vis[2 * h // 3:] = rnd(0, 256, (h - 2 * h // 3, w), torch.uint8)
        return vis

    for label, (w, h, blk, sh) in RANDOM_GEOMS:
        nbh, nbv = -(-w // blk), -(-h // blk)
        calls = []
        with recording(calls):
            vis = rnd_plane(w, h)
            bd = rnd(0, 64, (nbv, nbh), torch.uint8)
            filters.intra_filter_graph(w, h, nbh, nbv, vis, bd, 900, 160)
            mv = [rnd(-40, 41, (nbv, nbh)), rnd(-40, 41, (nbv, nbh)),
                  rnd(0, 256, (nbv, nbh)), rnd(0, 16, (nbv, nbh))]
            filters.luma_filter_graph(w, h, nbh, nbv, blk, blk, 1, vis,
                                      *mv, 900, 160, 1, 1)
            cw, ch = w >> sh, h >> sh
            filters.chroma_filter_graph(cw, ch, nbh, nbv, blk >> sh,
                                        blk >> sh,
                                        rnd_plane(cw, ch),
                                        *mv[:3], 700)
        for call in calls:
            filter_case("random_" + label, call)
    emit("filter_kernel_vs_plain", kernel="wavefront_filter",
         max_abs_err=wf_err, cases=list(wf_cases))

    # 4a. the layouts one CTA cannot hold whole (4:4:4 chroma at 1440p and
    # 4K, on a cluster; 16x16384 4:4:4 chroma, which no cluster holds, on
    # the global ring) and 4K luma and intra, against the native filters
    large = []
    for kind, w, h, shifts in (("intra", 3840, 2160, (1, 1)),
                               ("luma", 3840, 2160, (1, 1)),
                               ("chroma", 2560, 1440, (0, 0)),
                               ("chroma", 3840, 2160, (0, 0)),
                               ("chroma", 16, 16384, (0, 0))):
        args = golden.filter_case(kind, w, h, 32, shifts, seed=w, nb=1)
        want = golden.filter_native(kind, args)
        calls = []
        dargs = [a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args]
        with recording(calls):
            got = getattr(filters, kind + "_filter_graph")(*dargs)
        err = int((got.cpu().long() - want.long()).abs().max())
        wf_err = max(wf_err, err)
        (_, lay, src, props, scal), = calls
        plan = filters.wavefront_plan(lay, max_smem=_kernels.max_smem())
        work = src.clone()

        def run():
            work.copy_(src)
            wf(kind, lay, work, props, scal)
        rec = dict(case="native_%dx%d" % (w, h), kind=kind,
                   plane=[lay.pw, lay.ph], tile=[lay.tw, lay.th],
                   diagonals=lay.nd, lanes=lay.L, cluster=plan.C,
                   ring=plan.ring, smem=plan.smem, threads=plan.threads,
                   changed_px=int((want != args[
                       {"intra": 4, "luma": 7}.get(kind, 6)]).sum()),
                   max_abs_err=err, ms=cuda_ms(run, 3))
        large.append(rec)
        assert err == 0 and rec["changed_px"] > 0, rec
    assert [(r["cluster"], r["ring"]) for r in large] == [
        (1, "shared"), (1, "shared"), (2, "shared"), (4, "shared"),
        (1, "global")], large
    emit("filter_kernel_vs_native_large", kernel="wavefront_filter",
         max_abs_err=max(r["max_abs_err"] for r in large), cases=large)

    # 5. blob vs the host scan coder of the port's contract fallback,
    # every plane of 2 FHD frames
    pcfg, vs = chunk_scans(frames[:2], meta)
    planes = 0
    for c in range(3):
        cw, ch = pcfg.cdims[c]
        segs = tuple(hzcc.scan_segments(cw, ch))
        total = sum(n for n, _ in segs)
        blob, nbytes, fb = scan_pl.make_scan_blob(segs, blob_cap(total))(
            vs[c])
        for i in range(vs[c].shape[0]):
            assert not bool(fb[i]), ("fallback", c, i)
            want = plane.host_scan(vs[c][i].cpu().numpy(), cw, ch)
            got = blob[i, :int(nbytes[i])].cpu().numpy().tobytes()
            assert got == want, ("blob mismatch", c, i, len(got), len(want))
            planes += 1
    emit("blob_vs_native", planes=planes, equal=True)

    # 6. main path, encode: 32 FHD frames through encode_intra_batch
    want = gold[golden.key(golden.FHD, QP)]
    trace.enable(True)
    warm_ms, data = host_ms(lambda: golden.encode(
        cli, frames, meta, QP, batch=batch.encode_intra_batch, chunk=CHUNK,
        device=dev))
    assert golden.digest(data)["sha256"] == want["sha256"], "warm digest"
    trace.reset()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=QP, gop=0),
                           device=dev)
    out = batch.encode_intra_batch(enc, frames, chunk=CHUNK)
    out += enc.end_of_stream()
    data = b"".join(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    vk_launches = scan_pl.vk_chain.launches
    stages = trace.totals()
    sha = hashlib.sha256(data).hexdigest()
    assert sha == want["sha256"] and len(data) == want["length"], sha
    assert vk_launches > 0, "vk_chain never launched on the main path"
    emit("main_path", frames=NFRAMES, chunk=CHUNK, fps=NFRAMES / dt,
         seconds=dt, warm_seconds=warm_ms / 1e3, sha256=sha, bytes=len(data),
         golden=True, vk_chain_launches=vk_launches, stage_seconds=stages,
         fallback_planes=enc.stats.blob_fallbacks)
    del frames

    def decode_run(stream, key, nfr, captured=None):
        """Warm decode (recording the filter calls into `captured`), then
        a timed decode with every launch count set to 0 just before it.
        Returns the phase record; the decoded y4m must equal dsv2_tpu's."""
        want = gold[key]["decode"]
        with recording(captured if captured is not None else []):
            y = golden.decoded_y4m(decoder, y4m, stream,
                                   decoder=decoder.Decoder(device=dev))
        assert golden.digest(y) == want, (key, "warm decode digest")
        trace.reset()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = golden.decoded_y4m(decoder, y4m, stream,
                               decoder=decoder.Decoder(device=dev))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(wf.launches)
        assert golden.digest(y) == want, (key, "decode digest")
        assert scan_pl.vk_chain.launches == 0
        return dict(stream=key, frames=nfr, fps=nfr / dt, seconds=dt,
                    sha256=want["sha256"], golden=True,
                    filter_launches=launches, stage_seconds=trace.totals())

    # 7. main path, decode: the FHD intra stream just encoded
    captured = []
    rec = decode_run(data, golden.key(golden.FHD, QP), NFRAMES, captured)
    assert rec["filter_launches"]["intra"] > 0, rec
    emit("decode_main_path", **rec)
    dec_launches = sum(rec["filter_launches"].values())
    del data

    # 8. the P streams: FHD (8 frames) and CIF (12)
    for case in (golden.P_CASES[2], golden.P_CASES[1]):
        key = golden.p_key(case)
        stream = golden.read_stream(key)
        assert golden.digest(stream) == {k: gold[key][k]
                                         for k in ("sha256", "length")}
        rec = decode_run(stream, key, case[3],
                         captured if case[0] == golden.FHD else None)
        if case[0] == golden.FHD:
            for k in filters.KINDS:
                assert rec["filter_launches"][k] > 0, (k, rec)
            dec_launches += sum(rec["filter_launches"].values())
        emit("decode_p", **rec)

    # 8z. an FHD high-quality stream whose scans the compact upload cannot
    # carry (3 frames at -qp=90 -gop=0): encoded by the port, then decoded
    # on the device chain with the dense scan upload
    dname, dqp, dgop, dnfr = next(c for c in golden.DENSE_CASES
                                  if c[0] == golden.FHD)
    dkey = golden.key(dname, dqp, dgop)
    dframes, _ = cli.read_y4m(golden.input_path(dname))
    ddata = golden.encode(cli, dframes[:dnfr], meta, dqp,
                          batch=batch.encode_intra_batch, chunk=CHUNK,
                          gop=dgop, device=dev)
    del dframes
    assert golden.digest(ddata) == {k: gold[dkey][k]
                                    for k in ("sha256", "length")}, dkey
    uploads = []
    scan_upload = devsteps.scan_upload

    def counting_upload(*a):
        up = scan_upload(*a)
        uploads.append(up[1])
        return up
    devsteps.scan_upload = counting_upload
    try:
        rec = decode_run(ddata, dkey, dnfr)
    finally:
        devsteps.scan_upload = scan_upload
    assert uploads and all(uploads), uploads
    emit("decode_dense", dense_pictures=sum(uploads), qp=dqp, **rec)
    del ddata

    # 8a. the motion-search kernels vs their plain version (on the card),
    # level by level, on seeded CIF inputs without and with temporal
    # candidates; below also on the inputs of FHD P frames 1 and 2. (After
    # the intra and decode main paths, so those run in the parent's state.)
    hme_cases = []

    def hme_vs_plain(label, cfg, inputs, time_it=False):
        """Each level through its kernel and through the plain version, fed
        the same parent field; exact on every field. With time_it, each
        launch is timed with CUDA events and the plain version once."""
        (sp, rp, op, su, sv, ru, rv, tmx, tmy, quant, skt) = inputs
        quant, skt = int(quant), int(skt)
        tmv = torch.stack([tmx, tmy]).contiguous()
        gxy = torch.zeros(2, dtype=torch.int32, device=dev)
        parent = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=torch.int32,
                             device=dev)
        err, levels = 0, []
        for level in range(cfg.pyramid_levels, -1, -1):
            gx, gy = gxy[0], gxy[1]
            if level:
                got = hme_gpu.hme_level(cfg, level, sp[level], rp[level],
                                        op[level], parent, tmv, gxy, quant)
                torch.cuda.synchronize()
                pms, want = host_ms(lambda: torch.stack(
                    hme_wave.refine_level_graph(
                        cfg, level, sp[level], rp[level], op[level],
                        parent[0], parent[1], tmx, tmy, gx, gy, quant)))
                e = int((got.long() - want.long()).abs().max())
                kern = lambda: hme_gpu.hme_level(cfg, level, sp[level],
                                                 rp[level], op[level], parent,
                                                 tmv, gxy, quant)
                nbytes = 3 * sp[level].numel() + 4 * 6 * parent[0].numel()
            else:
                chroma = (su, sv, ru, rv)
                out, sums = hme_gpu.hme_level0(cfg, sp[0], rp[0], op[0],
                                               chroma, parent, tmv, gxy,
                                               quant, skt)
                torch.cuda.synchronize()
                pms, st = host_ms(lambda: hme_wave.refine_level0_graph(
                    cfg, (sp[0], su, sv), (rp[0], ru, rv), op[0], parent[0],
                    parent[1], tmx, tmy, gx, gy, quant, skt))
                want = torch.stack([st[k] for k in hme_wave.FIELDS0]
                                   + [st["fskip"].int()])
                wsum = torch.stack([st[k] for k in hme_wave.SUMS0])
                e = max(int((out.long() - want.long()).abs().max()),
                        int((sums.long() - wsum.long()).abs().max()))
                got = out
                kern = lambda: hme_gpu.hme_level0(cfg, sp[0], rp[0], op[0],
                                                  chroma, parent, tmv, gxy,
                                                  quant, skt)
                nbytes = (3 * sp[0].numel() + 4 * su.numel()
                          + 4 * (4 + hme_gpu.NF0) * parent[0].numel())
            rec = dict(level=level, max_abs_err=e)
            if time_it:
                rec["ms"] = cuda_ms(kern, 3)
                rec["plain_ms"] = pms
                # the level's planes and grids read once, fields written
                # once; a floor of 8 integer operations per pixel for two
                # metrics per block (the zero candidate and the
                # good-enough test every block runs)
                fw, fh = cfg.dims[level]
                rec["bound_ms"], rec["bound_by"] = bound(
                    nbytes, 2 * 8 * fw * fh)
            levels.append(rec)
            err = max(err, e)
            if level:
                parent = got
                gxy = torch.stack(hme_wave.global_motion_graph(
                    cfg, level, got[0], got[1]))
        rec = dict(case=label, nbh=cfg.nbh, nbv=cfg.nbv, has_tmv=cfg.has_tmv,
                   max_abs_err=err, levels=levels)
        hme_cases.append(rec)
        assert err == 0, rec
        return rec

    for tmv_on in (False, True):
        cfgd, inputs = golden.hme_case(cif_frames, cif_meta, has_tmv=tmv_on,
                                       device=dev)
        hme_vs_plain("cif_seeded_tmv%d" % tmv_on, hme_wave.WaveCfg(**cfgd),
                     inputs)
    emit("hme_kernel_vs_plain", kernels=["hme_level", "hme_level0"],
         max_abs_err=max(c["max_abs_err"] for c in hme_cases),
         cases=list(hme_cases))

    # 8b. main path, P encode: the first 8 FHD frames at -qp=60 -gop=8
    # through cli.make_encoder + encode_frame (1 I + 7 P frames). The warm
    # run records the motion search inputs of P frames 1 and 2.
    frames_p = cli.read_y4m(golden.input_path(golden.FHD))[0][:P_FRAMES]
    pkey = golden.p_key(golden.P_CASES[2])
    recorded = []
    make_me = hme_gpu.make_motion_est

    def recording_me(cfg):
        fn = make_me(cfg)

        def f(*inputs):
            if len(recorded) < 2:
                recorded.append((cfg, inputs))
            return fn(*inputs)
        return f

    hme_gpu.make_motion_est = recording_me
    p_vk_calls = []
    try:
        with recording_vk(p_vk_calls):
            warm_ms, pdata = host_ms(lambda: golden.encode(
                cli, frames_p, meta, QP, gop=P_GOP, device=dev))
    finally:
        hme_gpu.make_motion_est = make_me
    assert golden.digest(pdata) == {k: gold[pkey][k]
                                    for k in ("sha256", "length")}, \
        "warm P digest"
    trace.reset()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=QP, gop=P_GOP),
                           device=dev)
    out = []
    for fr in frames_p:
        out.extend(enc.encode_frame(fr))
    out.extend(enc.end_of_stream())
    pdata = b"".join(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hme_launches = {k: hme_gpu.launches[k]
                    for k in ("hme_level", "hme_level0")}
    p_filter_launches = dict(wf.launches)
    p_vk_launches = scan_pl.vk_chain.launches
    sha = hashlib.sha256(pdata).hexdigest()
    assert sha == gold[pkey]["sha256"] and len(pdata) == gold[pkey][
        "length"], sha
    assert all(n > 0 for n in hme_launches.values()), hme_launches
    assert p_vk_launches > 0, "vk_chain never launched on the P path"
    emit("p_encode_main_path", frames=P_FRAMES, gop=P_GOP,
         fps=P_FRAMES / dt, seconds=dt, warm_seconds=warm_ms / 1e3,
         sha256=sha, bytes=len(pdata), golden=True,
         hme_launches=hme_launches,
         hme_launches_expected={"hme_level": 7 * enc.pyramid_levels,
                                "hme_level0": 7},
         filter_launches=p_filter_launches, vk_chain_launches=p_vk_launches,
         stage_seconds=trace.totals())
    trace.enable(False)
    del frames_p
    # the vk kernel at B = 1 as the P paths launch it: P frame 1's luma
    # plane (after frame 0's three planes, the first of luma size)
    def luma_of_frame1(calls):
        rows = max(c[0].shape[0] for c in calls)
        return next(c for c in calls[3:] if c[0].shape[0] == rows)
    vk_b1 = [compare("fhd_p_frame1_luma_b1", *luma_of_frame1(p_vk_calls),
                     time_it=True)]
    del p_vk_calls

    # 8c. the motion-search kernels vs plain on FHD P frames 1 (no
    # temporal candidates) and 2 (with them), level by level, timed
    fhd_hme = [hme_vs_plain("fhd_p_frame%d" % (n + 1), c, inputs,
                            time_it=True)
               for n, (c, inputs) in enumerate(recorded)]
    assert [c["has_tmv"] for c in fhd_hme] == [False, True], fhd_hme
    emit("hme_kernel_vs_plain_fhd", kernels=["hme_level", "hme_level0"],
         max_abs_err=max(c["max_abs_err"] for c in fhd_hme), cases=fhd_hme)

    def repeat_equal(fn):
        """REPEATS runs of fn() (a dict of tensors) give identical output:
        the dataflow scheduler hands blocks to workers in another order
        each run, so a race would show as a difference."""
        first = {k: v.clone() for k, v in fn().items()}
        for _ in range(REPEATS - 1):
            got = fn()
            assert all(torch.equal(got[k], v) for k, v in first.items())
        torch.cuda.synchronize()
        return REPEATS

    cfg2, in2 = recorded[1]
    emit("hme_repeats", kernel="hme_level0", case="fhd_p_frame2",
         identical_runs=repeat_equal(
             lambda: hme_gpu.make_motion_est(cfg2)(*in2)))

    def upper_repeats(cfg, level_fn, nlanes):
        """REPEATS launches of every upper level (level_fn(level, parent,
        gxy) -> fields) identical, each level fed the fields of the one
        above; returns the levels."""
        parent = torch.zeros((nlanes, 2, cfg.nbv, cfg.nbh),
                             dtype=torch.int32, device=dev)
        gxy = torch.zeros((nlanes, 2), dtype=torch.int32, device=dev)
        levels = list(range(cfg.pyramid_levels, 0, -1))
        for level in levels:
            repeat_equal(lambda: {"f": level_fn(level, parent, gxy)})
            parent = level_fn(level, parent, gxy)
            gxy = hme_gang.global_motion_lanes(cfg, level, parent)
        return levels

    sp2, rp2, op2 = in2[:3]
    tmv2 = torch.stack([in2[7], in2[8]]).contiguous()
    emit("hme_repeats", kernel="hme_level", case="fhd_p_frame2",
         identical_runs=REPEATS, levels=upper_repeats(
             cfg2, lambda lv, par, gxy: hme_gpu.hme_level(
                 cfg2, lv, sp2[lv], rp2[lv], op2[lv], par[0], tmv2, gxy[0],
                 int(in2[9]))[None], 1))

    # 9. the filter kernel vs plain on the planes the FHD decodes fed it
    firsts = {}
    for call in captured:
        firsts.setdefault((call[0], call[1].pw), call)
    timed_wf = {}
    for (kind, pw), call in sorted(firsts.items()):
        label = "fhd_decode_%s_%d" % (kind, pw)
        timed_wf[kind, pw] = filter_case(label, call, time_it=True)
    # the FHD luma plane on clusters of 1, 2, 4 and 8 CTAs (the plan takes
    # one CTA there); every size against the plain version's output
    kind, lay, src, props, scal = firsts[("luma", meta.width)]
    src, props, scal = src[:1], props[:1], scal[:1]
    want = src.clone()
    filters.wavefront_filter_plain(kind, lay, want, props, scal)
    by_cluster = {}
    for c in filters.WF_CLUSTERS:
        work = src.clone()
        _kernels.wavefront_filter(1, lay, work, props, scal, cluster=c)
        err = int((work.long() - want.long()).abs().max())
        wf_err = max(wf_err, err)
        assert err == 0, ("cluster", c, err)

        def run(c=c):
            work.copy_(src)
            _kernels.wavefront_filter(1, lay, work, props, scal, cluster=c)
        by_cluster[c] = cuda_ms(run, 5)
    timed_wf[("luma", meta.width)]["ms_by_cluster"] = by_cluster
    emit("filter_kernel_vs_plain_decode", kernel="wavefront_filter",
         max_abs_err=wf_err, cases=wf_cases[-len(firsts):])

    # 10. the CLIs, in subprocesses on the card
    outdir = os.path.join(REPO, "build", "torch_smoke")
    os.makedirs(outdir, exist_ok=True)
    env = dict(os.environ, DSV2_TORCH_DEVICE=dev.type)
    cif_p = golden.p_key(golden.P_CASES[1])
    for argv, out, key, what in (
            (["e", "-qp=60", "-gop=0",
              "-inp=" + golden.input_path("cif352x288_420_12f")],
             "cif.dsv", golden.key("cif352x288_420_12f", 60), None),
            (["e", "-qp=60", "-gop=12",
              "-inp=" + golden.input_path("cif352x288_420_12f")],
             "cif_gop12.dsv", golden.p_key(golden.P_CASES[1]), None),
            (["d", "-y4m=1", "-inp=" + golden.stream_path(cif_p)],
             "cif_p.y4m", cif_p, "decode")):
        out = os.path.join(outdir, out)
        cmd = ([sys.executable, "-m", "dsv2_tpu_torch", argv[0], "-y",
                "-y4m=1"] + argv[1:] + ["-out=" + out])
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             env=env, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        with open(out, "rb") as f:
            got = golden.digest(f.read())
        ref = gold[key] if what is None else gold[key][what]
        assert got["sha256"] == ref["sha256"], (argv[0], got)
        emit("cli", command=argv[0], stream=key, sha256=got["sha256"],
             golden=True)

    # 10a. the inputs dsv2_tpu takes its host chain for, on the device
    # chain here; each path run with every count set to 0 just before it
    # and read just after. decode_corrupt: the 8 seeded byte-flip trials
    # of the committed CIF CRF stream (a corrupt P plane reconstructs
    # against a zero residual, a corrupt intra plane is zeroed, the filter
    # kernel runs on every picture); every frame against dsv2_tpu's digest.
    trace.enable(True)
    trials = golden.corrupt_streams()

    def decode_trials():
        frames_, bad = 0, {"p": 0, "intra": 0}
        for i, data_ in enumerate(trials):
            want = gold[golden.corrupt_key(i)]
            dec = decoder.Decoder(device=dev)
            counts = golden.count_bad_planes(dec)
            got = golden.decode_frames(decoder, y4m, data_, decoder=dec)
            assert got["frames"] == want["frames"], ("corrupt", i)
            assert got["decode"] == want["decode"] and got["error"] is None
            assert counts == want["bad_planes"], (i, counts)
            frames_ += len(got["frames"])
            for k in bad:
                bad[k] += counts[k]
        return frames_, bad

    warm_ms, _ = host_ms(decode_trials)
    trace.reset()
    reset_counts()
    dt_ms, (cframes, cbad) = host_ms(decode_trials)
    corrupt_launches = dict(wf.launches)
    assert cbad["p"] > 0 and cbad["intra"] > 0, cbad
    assert corrupt_launches["luma"] > 0 and corrupt_launches["intra"] > 0
    assert scan_pl.vk_chain.launches == 0
    emit("decode_corrupt", trials=len(trials), frames=cframes,
         corrupt_p_planes=cbad["p"], corrupt_intra_planes=cbad["intra"],
         fps=cframes / (dt_ms / 1e3), seconds=dt_ms / 1e3,
         warm_seconds=warm_ms / 1e3, golden=True,
         filter_launches=corrupt_launches, stage_seconds=trace.totals())

    # 10b. decode_arena: the degenerate geometries (352x16 4:2:0, 16x240
    # 4:2:0, 64x500 4:1:1; 4 seeded frames at -qp=60 -gop=2) encoded by
    # the port on the card to dsv2_tpu's streams, then decoded on the card
    # with the arena (the reference's transform scratch threaded from
    # plane to plane and frame to frame) to dsv2_tpu's y4m
    arena_cases = [(name_, qp_, gop_, cli.read_y4m(golden.input_path(name_)))
                   for name_, qp_, gop_ in golden.ARENA_CASES]

    def arena_run():
        recs = []
        for name_, qp_, gop_, (afr, ameta) in arena_cases:
            want = gold[golden.key(name_, qp_, gop_)]
            enc_ms, adata = host_ms(lambda: golden.encode(
                cli, afr, ameta, qp_, gop=gop_, device=dev))
            assert golden.digest(adata) == {
                k: want[k] for k in ("sha256", "length")}, name_
            dec = decoder.Decoder(device=dev)
            wf0 = sum(wf.launches.values())
            dec_ms, ay = host_ms(lambda: golden.decoded_y4m(
                decoder, y4m, adata, decoder=dec))
            assert golden.digest(ay) == want["decode"], name_
            dec_wf = sum(wf.launches.values()) - wf0
            assert dec_wf > 0 and dec._arena.is_cuda, name_
            recs.append(dict(stream=golden.key(name_, qp_, gop_),
                             frames=len(afr), encode_ms=enc_ms,
                             decode_ms=dec_ms, decode_filter_launches=dec_wf))
        return recs

    arena_run()
    trace.reset()
    reset_counts()
    arena_recs = arena_run()
    arena_vk = scan_pl.vk_chain.launches
    arena_wf = dict(wf.launches)
    arena_hme = {k: hme_gpu.launches[k] for k in ("hme_level", "hme_level0")}
    assert arena_vk > 0 and arena_hme["hme_level0"] > 0
    emit("decode_arena", cases=arena_recs, golden=True,
         vk_chain_launches=arena_vk, filter_launches=arena_wf,
         hme_launches=arena_hme, stage_seconds=trace.totals())

    # 10c. encode_host_hme: the CIF fixture at -qp=60 -gop=6, 8 frames,
    # with hme_backend "host" and "wave" (aliases of "pallas": kernels 4/5
    # and the device chain); both must be dsv2_tpu's "host" stream
    hname, hqp, hgop, hnfr, hbackend = golden.HOST_HME
    hkey = golden.key(hname, hqp, hgop)
    hframes, hmeta = cli.read_y4m(golden.input_path(hname))
    hframes = hframes[:hnfr]

    def host_encode(backend):
        """(stream, vk launches by frame type)."""
        enc = cli.make_encoder(hmeta, cli.default_enc_opts(qp=hqp, gop=hgop),
                               device=dev)
        enc.hme_backend = backend
        out, vk = [], {"p": 0, "intra": 0}
        for fr in hframes:
            n0, p0 = scan_pl.vk_chain.launches, enc.stats.pnum
            out.extend(enc.encode_frame(fr))
            vk["p" if enc.stats.pnum > p0 else "intra"] += (
                scan_pl.vk_chain.launches - n0)
        out.extend(enc.end_of_stream())
        return b"".join(out), vk

    host_recs = {}
    for backend in (hbackend, "wave"):
        host_ms(lambda: host_encode(backend))
        trace.reset()
        reset_counts()
        dt_ms, (hdata, hvk) = host_ms(lambda: host_encode(backend))
        assert golden.digest(hdata) == {k: gold[hkey][k]
                                        for k in ("sha256", "length")}, \
            backend
        hl = {k: hme_gpu.launches[k] for k in ("hme_level", "hme_level0")}
        assert hl["hme_level0"] > 0, (backend, hl)
        assert hvk["p"] > 0, hvk
        host_recs[backend] = dict(
            fps=hnfr / (dt_ms / 1e3), seconds=dt_ms / 1e3,
            vk_chain_launches=hvk, hme_launches=hl,
            filter_launches=dict(wf.launches), stage_seconds=trace.totals())
    trace.enable(False)
    emit("encode_host_hme", stream=hkey, frames=hnfr, gop=hgop, qp=hqp,
         golden=True, backends=host_recs)
    # 11. the gang motion-search kernels (6/7) level by level: 8 seeded
    # CIF lanes (each another frame, shift, noise and quant), without and
    # with temporal candidates, every lane against kernels 4/5, 2 lanes (8
    # where timed) against the plain version; and the inputs of FHD P
    # frames 1 and 2 as 2 lanes against kernels 4/5 (under frame 2's
    # WaveCfg: a launch's lanes share one). Timed: one launch for all lanes
    # next to kernels 4/5 looping over the same lanes, at 1, 2 and 4
    # blocks per warp.
    gang_cases = []

    def gang_vs(label, cfg, lanes, nplain, time_it=False):
        """Each level through one gang launch for every lane, kernels 4/5
        per lane and the plain version for the first `nplain` lanes, all
        fed the gang's parent field; exact on every field and sum."""
        n = len(lanes)
        srcs, refs, ogrs = ([ln[k] for ln in lanes] for k in range(3))
        chromas = [tuple(ln[3:7]) for ln in lanes]
        tmv = torch.stack([torch.stack([ln[7], ln[8]]) for ln in lanes]
                          ).contiguous()
        quants = [int(ln[9]) for ln in lanes]
        skts = [int(ln[10]) for ln in lanes]
        gxy = torch.zeros((n, 2), dtype=torch.int32, device=dev)
        parent = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=torch.int32,
                             device=dev)
        err, levels = 0, []
        for level in range(cfg.pyramid_levels, -1, -1):
            lv = [x[level] for x in srcs], [x[level] for x in refs], \
                [x[level] for x in ogrs]
            if level:
                def gang_fn(g=None):
                    return hme_gpu.hme_gang_level(cfg, level, *lv, parent,
                                                  tmv, gxy, quants, gang=g)

                def pallas_fn():
                    return [hme_gpu.hme_level(
                        cfg, level, lv[0][i], lv[1][i], lv[2][i], parent[i],
                        tmv[i], gxy[i], quants[i]) for i in range(n)]

                def plain_fn(i):
                    return torch.stack(hme_wave.refine_level_graph(
                        cfg, level, lv[0][i], lv[1][i], lv[2][i],
                        parent[i, 0], parent[i, 1], tmv[i, 0], tmv[i, 1],
                        gxy[i, 0], gxy[i, 1], quants[i]))
                got = gang_fn()
                want = torch.stack(pallas_fn())
                nbytes = n * (3 * lv[0][0].numel()
                              + 4 * 6 * parent[0, 0].numel())
            else:
                def gang_fn(g=None):
                    return hme_gpu.hme_gang_level0(cfg, *lv, chromas, parent,
                                                   tmv, gxy, quants, skts,
                                                   gang=g)

                def pallas_fn():
                    return [hme_gpu.hme_level0(
                        cfg, lv[0][i], lv[1][i], lv[2][i], chromas[i],
                        parent[i], tmv[i], gxy[i], quants[i], skts[i])
                        for i in range(n)]

                def plain_fn(i):
                    st = hme_wave.refine_level0_graph(
                        cfg, (lv[0][i],) + chromas[i][:2],
                        (lv[1][i],) + chromas[i][2:], lv[2][i], parent[i, 0],
                        parent[i, 1], tmv[i, 0], tmv[i, 1], gxy[i, 0],
                        gxy[i, 1], quants[i], skts[i])
                    return torch.cat([torch.stack(
                        [st[k] for k in hme_wave.FIELDS0]
                        + [st["fskip"].int()]).flatten(),
                        torch.stack([st[k] for k in hme_wave.SUMS0])])
                out, sums = gang_fn()
                got = torch.cat([out.flatten(1), sums], 1)
                want = torch.stack([torch.cat([o.flatten(), sm]) for o, sm
                                    in pallas_fn()])
                nbytes = n * (3 * lv[0][0].numel() + 4 * chromas[0][0].numel()
                              + 4 * (4 + hme_gpu.NF0) * parent[0, 0].numel())
            torch.cuda.synchronize()
            e = int((got.long() - want.long()).abs().max())
            if nplain:
                pms, plain = host_ms(lambda: torch.stack(
                    [plain_fn(i) for i in range(nplain)]))
                e = max(e, int((got[:nplain].flatten(1).long()
                                - plain.flatten(1).long()).abs().max()))
            rec = dict(level=level, lanes=n, max_abs_err=e)
            if time_it:
                rec["ms_by_gang"] = {g: cuda_ms(lambda g=g: gang_fn(g), 3)
                                     for g in (1, 2, 4)}
                rec["ms"] = rec["ms_by_gang"][hme_gpu.GANG]
                rec["pallas_ms"] = cuda_ms(pallas_fn, 3)
                if nplain:
                    rec["plain_ms"] = pms
                    rec["plain_lanes"] = nplain
                fw, fh = cfg.dims[level]
                rec["bound_ms"], rec["bound_by"] = bound(
                    nbytes, n * 2 * 8 * fw * fh)
            levels.append(rec)
            err = max(err, e)
            if level:
                parent = got
                gxy = hme_gang.global_motion_lanes(cfg, level, got)
        rec = dict(case=label, nbh=cfg.nbh, nbv=cfg.nbv, has_tmv=cfg.has_tmv,
                   max_abs_err=err, levels=levels)
        gang_cases.append(rec)
        assert err == 0, rec
        return rec

    for tmv_on in (False, True):
        cfgd, lanes = golden.hme_lanes(cif_frames, cif_meta, 8,
                                       has_tmv=tmv_on, device=dev)
        gang_vs("cif_seeded_x8_tmv%d" % tmv_on, hme_wave.WaveCfg(**cfgd),
                lanes, 8 if tmv_on else 2, time_it=tmv_on)
    (_, in1), (cfg2, in2) = recorded
    gang_vs("fhd_p_frames_1_2", cfg2, [in1, in2], 0, time_it=True)
    del recorded
    gang_err = max(c["max_abs_err"] for c in gang_cases)
    emit("hme_gang_vs_plain", kernels=["hme_gang_level", "hme_gang_level0"],
         gang=hme_gpu.GANG, max_abs_err=gang_err, cases=gang_cases)
    cif_gang = gang_cases[1]["levels"]
    cfgd, lanes = golden.hme_lanes(cif_frames, cif_meta, 8, has_tmv=True,
                                   device=dev)
    gcfg = hme_wave.WaveCfg(**cfgd)
    emit("hme_repeats", kernel="hme_gang_level0", case="cif_seeded_x8",
         identical_runs=repeat_equal(
             lambda: hme_gang.make_motion_est(gcfg)(lanes)))
    gtmv = torch.stack([torch.stack([ln[7], ln[8]]) for ln in lanes]
                       ).contiguous()
    emit("hme_repeats", kernel="hme_gang_level", case="cif_seeded_x8",
         identical_runs=REPEATS, levels=upper_repeats(
             gcfg, lambda lv, par, gxy: hme_gpu.hme_gang_level(
                 gcfg, lv, [ln[0][lv] for ln in lanes],
                 [ln[1][lv] for ln in lanes], [ln[2][lv] for ln in lanes],
                 par, gtmv, gxy, [int(ln[9]) for ln in lanes]), len(lanes)))
    del lanes

    # 12. main path, lockstep P encode (BASELINE config 1): the seeded
    # synthetic CIF clip cut into 8 streams of 48 frames at -qp=60 -gop=48
    # through cli.make_encoder + dynbatch.encode_streams_lockstep(width=8),
    # hme_backend="gang"; every lane against its golden digest, then
    # groups=2 x width 4, then kernels 4/5 ("pallas") on the first
    # LS_PALLAS_FRAMES frames of each lane.
    name, qp, gop, nlanes, per = golden.LOCKSTEP
    ls_frames, ls_meta = cli.read_y4m(golden.input_path(name))
    streams = [golden.lane_frames(ls_frames, i) for i in range(nlanes)]
    del ls_frames
    want_ls = [gold[golden.lane_key(i)] for i in range(nlanes)]
    flush_lanes, ls_levels = [], set()
    make_gang = hme_gang.make_motion_est

    def counting_gang(cfg):
        fn = make_gang(cfg)

        def f(lanes):
            flush_lanes.append(len(lanes))
            ls_levels.add(cfg.pyramid_levels)
            return fn(lanes)
        return f

    def lockstep(strs, backend, **kw):
        def factory():
            enc = cli.make_encoder(ls_meta, cli.default_enc_opts(qp=qp,
                                                                 gop=gop),
                                   device=dev)
            enc.hme_backend = backend
            return enc
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dynbatch.encode_streams_lockstep(strs, factory, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    # one lane's P frame 1 (frames 0-1 of lane 0, encoded alone): its luma
    # plane's vk chain at B = 1
    lane_calls = []
    with recording_vk(lane_calls):
        lenc = cli.make_encoder(ls_meta, cli.default_enc_opts(qp=qp, gop=gop),
                                device=dev)
        for fr in streams[0][:2]:
            lenc.encode_frame(fr)
    vk_b1.append(compare("cif_lane_p_frame1_luma_b1",
                         *luma_of_frame1(lane_calls), time_it=True))
    del lane_calls, lenc
    emit("vk_b1", kernel="vk_chain", cases=vk_b1)
    warm_s, _ = lockstep([st[:LS_WARM_FRAMES] for st in streams], "gang",
                         width=nlanes)
    trace.enable(True)
    trace.reset()
    reset_counts()
    hme_gang.make_motion_est = counting_gang
    try:
        dt, out = lockstep(streams, "gang", width=nlanes)
    finally:
        hme_gang.make_motion_est = make_gang
    stages = trace.totals()
    trace.enable(False)
    ls_launches = {k: hme_gpu.launches[k]
                   for k in ("hme_gang_level", "hme_gang_level0")}
    ls_filter_launches = dict(wf.launches)
    ls_vk_launches = scan_pl.vk_chain.launches
    assert ls_vk_launches > 0, "vk_chain never launched on the lockstep path"
    digests = [golden.digest(o) for o in out]
    for i, (got, w) in enumerate(zip(digests, want_ls)):
        assert got == {k: w[k] for k in ("sha256", "length")}, (i, got)
    nflush = len(flush_lanes)
    assert len(ls_levels) == 1, ls_levels
    expect = {"hme_gang_level": nflush * ls_levels.pop(),
              "hme_gang_level0": nflush}
    assert flush_lanes == [nlanes] * (per - 1), flush_lanes
    assert ls_launches == expect, (ls_launches, expect)
    assert hme_gpu.launches["hme_level0"] == 0
    emit("lockstep_p_encode", lanes=nlanes, frames_per_lane=per, gop=gop,
         qp=qp, fps=nlanes * per / dt, seconds=dt, warm_seconds=warm_s,
         warm_frames_per_lane=LS_WARM_FRAMES, golden=True,
         sha256=[d["sha256"] for d in digests], hme_flushes=nflush,
         lanes_per_flush=sorted(set(flush_lanes)), hme_launches=ls_launches,
         hme_launches_expected=expect, filter_launches=ls_filter_launches,
         vk_chain_launches=ls_vk_launches, stage_seconds=stages)
    dt2, out2 = lockstep(streams, "gang", width=nlanes // 2, groups=2)
    assert out2 == out, "groups=2 bytes differ"
    emit("lockstep_p_encode_groups2", lanes=nlanes, groups=2,
         width=nlanes // 2, fps=nlanes * per / dt2, seconds=dt2, equal=True)
    n0 = hme_gpu.launches["hme_level0"]
    dt3, out3 = lockstep([st[:LS_PALLAS_FRAMES] for st in streams], "pallas",
                         width=nlanes)
    for o3, o in zip(out3, out):
        assert o.startswith(o3), "pallas lockstep bytes differ"
    assert hme_gpu.launches["hme_level0"] - n0 == nlanes * (
        LS_PALLAS_FRAMES - 1)
    emit("lockstep_p_encode_pallas", lanes=nlanes,
         frames_per_lane=LS_PALLAS_FRAMES, fps=nlanes * LS_PALLAS_FRAMES / dt3,
         seconds=dt3, equal_to_gang_prefix=True)
    # 12b. one group narrower than the streams: the 8 lanes at width 3,
    # each flush run as launches of at most 3 lanes
    width, nfr = LS_NARROW
    flush_lanes.clear()
    hme_gang.make_motion_est = counting_gang
    try:
        dt4, out4 = lockstep([st[:nfr] for st in streams], "gang",
                             width=width)
    finally:
        hme_gang.make_motion_est = make_gang
    for o4, o in zip(out4, out):
        assert o.startswith(o4), "narrow lockstep bytes differ"
    assert max(flush_lanes) == width and sum(flush_lanes) == nlanes * (
        nfr - 1), flush_lanes
    emit("lockstep_p_encode_narrow", lanes=nlanes, width=width,
         frames_per_lane=nfr, fps=nlanes * nfr / dt4, seconds=dt4,
         lanes_per_launch=sorted(set(flush_lanes)), equal_to_gang_prefix=True)
    del streams, out, out2, out3, out4

    # 13. the gang cost probe (kernel 8): its tool's run, each probe
    # against its plain version, the times and the block/gang parity
    reset_counts()
    probe = probe_gang.run(dev, reps=20)
    probe_launches = sum(probe_gang.launches.values())
    assert all(probe_gang.launches.values()), probe_gang.launches
    probe_err = max(r["max_abs_err"] for r in probe["probes"])
    assert probe_err == 0, probe
    pg_plane, pg_cx, pg_cy = probe_gang.inputs(device=dev)
    pg_plain_ms, _ = host_ms(lambda: probe_gang.gang_plain(
        "full", pg_plane, pg_cx, pg_cy))
    pg_full = next(r for r in probe["probes"]
                   if (r["variant"], r["mode"]) == ("gang", "full"))
    # the plane read once, cx, cy and the sums; ~20 integer operations per
    # pixel of each evaluation's 16x16 window
    pg_bound = bound(pg_plane.numel() + 12 * probe_gang.NB,
                     20 * 256 * probe_gang.NB * probe_gang.EVALS)
    emit("gang_probe", launches=dict(probe_gang.launches),
         plain_ms_gang_full=pg_plain_ms, **probe)

    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "dsv2_tpu")], \
        "the port imported jax or dsv2_tpu"

    def per_search(levels):
        """The upper levels' ms by level and summed over a search, and
        their bounds summed (kernels 4 and 6 run once per upper level)."""
        up = [lv for lv in levels if lv["level"] > 0]
        return dict(ms_by_level={lv["level"]: lv["ms"] for lv in up},
                    ms_per_search=sum(lv["ms"] for lv in up),
                    plain_ms_per_search=sum(lv["plain_ms"] for lv in up),
                    bound_ms_per_search=sum(lv["bound_ms"] for lv in up))

    luma = timed[-1]
    hvk = {b: sum(r["vk_chain_launches"].values())
           for b, r in host_recs.items()}
    vk_paths = {"intra_encode": vk_launches, "p_encode": p_vk_launches,
                "lockstep_p_encode": ls_vk_launches,
                "decode_arena": arena_vk,
                "encode_host_hme": hvk[hbackend],
                "encode_wave": hvk["wave"]}
    wmain = timed_wf[("intra", meta.width)]
    wf_paths = {"decode": dec_launches,
                "p_encode": sum(p_filter_launches.values()),
                "lockstep_p_encode": sum(ls_filter_launches.values()),
                "decode_corrupt": sum(corrupt_launches.values()),
                "decode_arena": sum(arena_wf.values()),
                "encode_host_hme": sum(host_recs[hbackend][
                    "filter_launches"].values()),
                "encode_wave": sum(host_recs["wave"][
                    "filter_launches"].values())}
    hme_paths = {name: {"p_encode": hme_launches[name],
                        "decode_arena": arena_hme[name],
                        "encode_host_hme": host_recs[hbackend][
                            "hme_launches"][name],
                        "encode_wave": host_recs["wave"]["hme_launches"][
                            name]}
                 for name in ("hme_level", "hme_level0")}
    print(json.dumps({"kernels": [
        {"name": "vk_chain", "route": "cuda",
         "source": "dsv2_tpu_torch/csrc/vk_chain.cu",
         "replaces": "dsv2_tpu/ops/scan_pl.py:133",
         "launches": sum(vk_paths.values()),
         "launches_by_path": vk_paths, "max_abs_err": vk_err,
         "ms": luma["ms"], "plain_ms": luma["plain_ms"],
         "bound_ms": luma["bound_ms"], "bound_by": luma["bound_by"],
         "library_ms": None, "met_at_start": luma["met_at_start"],
         "ms_b1": {r["case"]: r["ms"] for r in vk_b1},
         "bound_ms_b1": {r["case"]: r["bound_ms"] for r in vk_b1}},
        {"name": "wavefront_filter", "route": "cuda",
         "source": "dsv2_tpu_torch/csrc/wavefront_filter.cu",
         "replaces": "dsv2_tpu/ops/filters_pl.py:273",
         "also_replaces": "dsv2_tpu/ops/filters_pl.py:368",
         "launches": sum(wf_paths.values()),
         "launches_by_path": wf_paths, "max_abs_err": wf_err,
         "ms": wmain["ms"], "plain_ms": wmain["plain_ms"],
         "bound_ms": wmain["bound_ms"], "bound_by": wmain["bound_by"],
         "library_ms": None}] + [
        {"name": name, "route": "cuda",
         "source": "dsv2_tpu_torch/csrc/hme_search.cu",
         "replaces": "dsv2_tpu/ops/hme_pallas.py:%d" % line,
         "launches": sum(hme_paths[name].values()),
         "launches_by_path": hme_paths[name],
         "max_abs_err": max(c["max_abs_err"] for c in hme_cases),
         "ms": lv["ms"], "plain_ms": lv["plain_ms"],
         "bound_ms": lv["bound_ms"], "bound_by": lv["bound_by"],
         "library_ms": None, **extra}
        for name, line, lv, extra in (
            ("hme_level", 248, fhd_hme[0]["levels"][-2],
             per_search(fhd_hme[0]["levels"])),
            ("hme_level0", 311, fhd_hme[0]["levels"][-1], {}))] + [
        {"name": name, "route": "cuda",
         "source": "dsv2_tpu_torch/csrc/hme_gang.cu",
         "replaces": "dsv2_tpu/ops/hme_gang.py:%d" % line,
         "launches": ls_launches[name], "max_abs_err": gang_err,
         "ms": lv["ms"], "plain_ms": lv["plain_ms"],
         "bound_ms": lv["bound_ms"], "bound_by": lv["bound_by"],
         "library_ms": None, **extra}
        for name, line, lv, extra in (
            ("hme_gang_level", 1057, cif_gang[-2], per_search(cif_gang)),
            ("hme_gang_level0", 1139, cif_gang[-1], {}))] + [
        {"name": "probe_gang", "route": "cuda",
         "source": "dsv2_tpu_torch/csrc/probe_gang.cu",
         "replaces": "tools/probe_gang.py:33",
         "launches": probe_launches, "max_abs_err": probe_err,
         "ms": pg_full["ms"], "plain_ms": pg_plain_ms,
         "bound_ms": pg_bound[0], "bound_by": pg_bound[1],
         "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
