#!/usr/bin/env python3
"""Smoke run of the torch port (dsv2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — FHD 1920x1080 4:2:0 intra encode at -qp=60
-gop=0, 32 frames, through parallel/batch.encode_intra_batch — after
building every CUDA kernel on that path from this checkout and holding
each against its plain PyTorch version. Each phase prints one JSON line;
any failure raises (non-zero exit). The last lines are the kernel table,
the card's name and power limit, and the result line
{"ok": true, "device": {...}}. Needs CUDA, nvcc and this repository (no
JAX: the golden digests come from tests/golden/torch_port_streams.json).
Writes only under build/.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NFRAMES, CHUNK, QP = 32, 16, 60


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


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_port_golden as golden
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec import plane
    from dsv2_tpu_torch.codec.devsteps import blob_cap
    from dsv2_tpu_torch.ops import _kernels, hzcc, scan_pl
    from dsv2_tpu_torch.parallel import batch
    from dsv2_tpu_torch.utils import trace

    dev = torch.device("cuda")
    gold = golden.load()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build every kernel of the path from this checkout
    t0 = time.perf_counter()
    so = _kernels.build("vk_chain")
    _kernels.entry("vk_chain")
    emit("build", kernel="vk_chain", library=os.path.relpath(so, REPO),
         seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=_kernels.build_seconds.get("vk_chain"))

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

    # 3. kernel vs plain version, bit-exact on every row
    max_err = 0
    compared = []

    def compare(label, thr, s0, nnz, time_it=False):
        nonlocal max_err
        got = scan_pl.vk_chain(thr, s0, nnz)
        torch.cuda.synchronize()
        plain_ms, want = host_ms(lambda: scan_pl.vk_chain_plain(thr, s0,
                                                                nnz))
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        rec = dict(case=label, npad=thr.shape[0], B=thr.shape[1],
                   live_rows=int((nnz - s0).clamp(min=0).sum()),
                   max_abs_err=err)
        if time_it:
            rec["ms"] = cuda_ms(lambda: scan_pl.vk_chain(thr, s0, nnz), 20)
            rec["plain_ms"] = plain_ms
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
    emit("kernel_vs_plain", kernel="vk_chain", max_abs_err=max_err,
         cases=compared)

    # 4. device blob vs the host scan coder of the port's contract
    # fallback, every plane of 2 FHD frames
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

    # 5. the main path: 32 FHD frames through encode_intra_batch
    want = gold[golden.key(golden.FHD, QP)]

    trace.enable(True)
    warm_ms, data = host_ms(lambda: golden.encode(
        cli, frames, meta, QP, batch=batch.encode_intra_batch, chunk=CHUNK,
        device=dev))
    assert golden.digest(data)["sha256"] == want["sha256"], "warm digest"
    trace.reset()
    scan_pl.vk_chain.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=QP, gop=0),
                           device=dev)
    out = batch.encode_intra_batch(enc, frames, chunk=CHUNK)
    out += enc.end_of_stream()
    data = b"".join(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = scan_pl.vk_chain.launches
    stages = trace.totals()
    trace.enable(False)
    sha = hashlib.sha256(data).hexdigest()
    assert sha == want["sha256"] and len(data) == want["length"], sha
    assert launches > 0, "vk_chain never launched on the main path"
    assert "jax" not in sys.modules, "the port imported jax"
    emit("main_path", frames=NFRAMES, chunk=CHUNK, fps=NFRAMES / dt,
         seconds=dt, warm_seconds=warm_ms / 1e3, sha256=sha, bytes=len(data),
         golden=True, vk_chain_launches=launches, stage_seconds=stages,
         fallback_planes=enc.stats.blob_fallbacks)

    # 6. the CLI, in a subprocess on the card
    outdir = os.path.join(REPO, "build", "torch_smoke")
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, "cif.dsv")
    cmd = [sys.executable, "-m", "dsv2_tpu_torch", "e", "-y", "-y4m=1",
           "-qp=60", "-gop=0",
           "-inp=" + golden.input_path("cif352x288_420_12f"), "-out=" + out]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, DSV2_TORCH_DEVICE="cuda"),
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out, "rb") as f:
        cif = golden.digest(f.read())
    assert cif["sha256"] == gold[golden.key("cif352x288_420_12f", 60)][
        "sha256"], cif
    emit("cli", input="cif352x288_420_12f", sha256=cif["sha256"],
         golden=True)

    luma = timed[1]
    print(json.dumps({"kernels": [{
        "name": "vk_chain", "route": "cuda",
        "source": "dsv2_tpu_torch/csrc/vk_chain.cu",
        "replaces": "dsv2_tpu/ops/scan_pl.py:133",
        "launches": launches, "max_abs_err": max_err,
        "ms": luma["ms"], "plain_ms": luma["plain_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
