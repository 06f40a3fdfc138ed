#!/usr/bin/env python3
"""Smoke run of the torch port (dsv2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths through the entry points a user calls:
FHD 1920x1080 4:2:0 intra encode at -qp=60 -gop=0, 32 frames, through
parallel/batch.encode_intra_batch; then the decode of that stream and of
the committed FHD and CIF P streams through
codec/decoder.decode_stream_chunked, and both CLIs (`e`, `d`) in
subprocesses. Before that it builds every CUDA kernel of those paths
from this checkout (one nvcc per source, all at once) and holds each
against its plain PyTorch version: the vk chain on random and FHD scan
inputs, the in-loop filter wavefront (three kinds) on seeded random
planes at CIF and FHD geometry and on the planes the FHD decodes feed
it. Each phase prints one JSON line; any failure raises (non-zero exit).
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
KERNELS = ("vk_chain", "wavefront_filter")
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
    from dsv2_tpu_torch.codec import decoder, plane
    from dsv2_tpu_torch.codec.devsteps import blob_cap
    from dsv2_tpu_torch.ops import _kernels, filters, hzcc, scan_pl
    from dsv2_tpu_torch.parallel import batch
    from dsv2_tpu_torch.utils import trace, y4m

    dev = torch.device("cuda")
    gold = golden.load()
    wf = filters.wavefront_filter

    def reset_counts():
        scan_pl.vk_chain.launches = 0
        for k in filters.KINDS:
            wf.launches[k] = 0

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
        _kernels.entry(name)
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
        nonlocal vk_err
        got = scan_pl.vk_chain(thr, s0, nnz)
        torch.cuda.synchronize()
        plain_ms, want = host_ms(lambda: scan_pl.vk_chain_plain(thr, s0,
                                                                nnz))
        err = int((got.long() - want.long()).abs().max())
        vk_err = max(vk_err, err)
        live = int((nnz - s0).clamp(min=0).sum())
        rec = dict(case=label, npad=thr.shape[0], B=thr.shape[1],
                   live_rows=live, max_abs_err=err)
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
    pcfg, vs = chunk_scans(frames[:CHUNK], meta)
    timed = []
    for c, label in ((1, "fhd_chroma_chunk"), (0, "fhd_luma_chunk")):
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
    trace.enable(False)

    # 9. the filter kernel vs plain on the planes the FHD decodes fed it
    firsts = {}
    for call in captured:
        firsts.setdefault((call[0], call[1].pw), call)
    timed_wf = {}
    for (kind, pw), call in sorted(firsts.items()):
        label = "fhd_decode_%s_%d" % (kind, pw)
        timed_wf[kind, pw] = filter_case(label, call, time_it=True)
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
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "dsv2_tpu")], \
        "the port imported jax or dsv2_tpu"

    luma = timed[1]
    wmain = timed_wf[("intra", meta.width)]
    print(json.dumps({"kernels": [
        {"name": "vk_chain", "route": "cuda",
         "source": "dsv2_tpu_torch/csrc/vk_chain.cu",
         "replaces": "dsv2_tpu/ops/scan_pl.py:133",
         "launches": vk_launches, "max_abs_err": vk_err,
         "ms": luma["ms"], "plain_ms": luma["plain_ms"],
         "bound_ms": luma["bound_ms"], "bound_by": luma["bound_by"],
         "library_ms": None},
        {"name": "wavefront_filter", "route": "cuda",
         "source": "dsv2_tpu_torch/csrc/wavefront_filter.cu",
         "replaces": "dsv2_tpu/ops/filters_pl.py:273",
         "also_replaces": "dsv2_tpu/ops/filters_pl.py:368",
         "launches": dec_launches, "max_abs_err": wf_err,
         "ms": wmain["ms"], "plain_ms": wmain["plain_ms"],
         "bound_ms": wmain["bound_ms"], "bound_by": wmain["bound_by"],
         "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
