#!/usr/bin/env python3
"""Where the torch port's FHD intra encode spends its time, on one GPU.

    python3 tools/torch_profile.py [--out DIR]

Input: the seeded synthetic clip of chip_smoke.py's main path (1920x1080
4:2:0, 32 frames, -qp=60 -gop=0, chunk 16). Prints one JSON line each:

  layers   device ms of each layer of one 16-frame chunk (CUDA events,
           mean of 5 runs after a warm-up): HVS analysis; forward SBT,
           quantize and scan blob per plane; inside the scan blob, the
           slot compaction and the vk kernel. Also the whole chunk's
           device pass, the host time to enqueue it, and peak device
           memory of one chunk.
  scatter  the scan blob's emission scatter-add, per plane, timed as the
           path issues it and with every zero-valued contribution moved
           to a word of its own (adding 0 changes no word: the bytes are
           equal, and the script checks it). With the share of
           contributions that are zero, the share that land on the most
           hit word of their row, and (largest over rows) how many words
           that word lies from the last word that receives bits.
  profile  torch.profiler over one 32-frame encode_intra_batch (after a
           warm run): host wall time, device time as the union of the
           kernel and copy intervals, the busy share with the profiler
           on, and the ten kernels with the most device time. The full
           table goes to DIR/torch_profile_table.txt.

Needs CUDA and nvcc; writes under build/ and DIR (default chiprun_out/).
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFRAMES, CHUNK, QP = 32, 16, 60


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def dev_ms(fn, reps=5):
    """Mean device ms of fn() over reps runs, after one warm-up."""
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


def capture_scatter(fn):
    """Run fn() and return its result with the (out shape, dim, index,
    src) of every aten scatter_add_ it issued."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Capture(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.scatter_add_.default:
                out, dim, idx, src = args
                calls.append((tuple(out.shape), dim, idx, src))
            return func(*args, **(kwargs or {}))

    with Capture():
        res = fn()
    return res, calls


def scatter_study(shape, dim, idx, src):
    """Time one emission scatter-add as issued and with its zero-valued
    contributions spread to distinct words; check that both give the
    same words."""
    import torch
    assert dim == 1 and len(shape) == 2
    ncol = shape[1]
    col = torch.arange(idx.shape[1], device=idx.device) % ncol
    spread = torch.where(src != 0, idx, col.expand_as(idx))

    def run(ix):
        return torch.zeros(shape, dtype=src.dtype,
                           device=src.device).scatter_add_(1, ix, src)

    assert torch.equal(run(idx), run(spread)), "spread changed the words"
    rows = torch.arange(shape[0], device=idx.device)[:, None] * ncol
    hits = torch.bincount((idx + rows).reshape(-1),
                          minlength=shape[0] * ncol).reshape(shape)
    top, where = hits.max(dim=1)
    last = torch.where(src != 0, idx, -1).max(dim=1).values
    ms_as_is = dev_ms(lambda: run(idx))
    ms_spread = dev_ms(lambda: run(spread))
    return dict(contributions=idx.numel(),
                zero_share=float((src == 0).float().mean()),
                top_word_share=float(top.sum()) / idx.numel(),
                top_word_past_last_bits_max=int((where - last).abs().max()),
                ms_as_issued=ms_as_is, ms_zeros_spread=ms_spread)


def kernel_busy_ms(prof):
    """Union of the device intervals (kernels, copies, sets) in a
    torch.profiler run, in ms, and the list of (name, self device ms)."""
    import torch
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy / 1e3, sorted(by_name.items(), key=lambda kv: -kv[1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_profile: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_port_golden as golden
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec.devsteps import blob_cap
    from dsv2_tpu_torch.ops import blockanalysis, hzcc, sbt, scan_pl
    from dsv2_tpu_torch.parallel import batch

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    frames, meta = cli.read_y4m(golden.input_path(golden.FHD))
    assert len(frames) == NFRAMES

    # layers of one 16-frame chunk
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=QP, gop=0),
                           device=dev)
    ctx = batch._prep_chunk(enc, frames[:CHUNK])
    pcfg, p = ctx["pcfg"], ctx["p"]
    assert ctx["analyze"]
    xs, bds, qs = batch._chunk_inputs(enc, ctx)
    fn = batch._device_batch_fn(meta.width, meta.height, meta.subsamp,
                                p.blk_w, p.blk_h, p.lossless, p.do_psy,
                                True)
    def chunk():
        return fn(xs[0], xs[1], xs[2], bds, qs)

    _, _, vs, (_, bd) = chunk()
    torch.cuda.synchronize()
    lay = dict(chunk_ms=dev_ms(chunk))
    t0 = time.perf_counter()
    chunk()
    lay["chunk_enqueue_host_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk()
    torch.cuda.synchronize()
    lay["chunk_peak_bytes"] = torch.cuda.max_memory_allocated()
    flags = blockanalysis.device_intra_flags(pcfg)
    lay["analysis_ms"] = dev_ms(lambda: flags(xs[0], xs[1], xs[2]))
    scatter = []
    for c in range(3):
        x = xs[c].to(torch.int32) - 128
        fwd = sbt.make_fwd_sbt_carry(pcfg.sbt_cfg(c))
        quant = hzcc.make_quantize(pcfg.hzcc_cfg(c))
        coefs, _ = fwd(x, bd)
        segs = tuple(hzcc.scan_segments(*pcfg.cdims[c]))
        blob = scan_pl.make_scan_blob(segs, blob_cap(sum(n for n, _ in segs)))
        vk_in = scan_pl.vk_chain_inputs(segs, vs[c])
        lay["sbt_ms_%d" % c] = dev_ms(lambda: fwd(x, bd))
        lay["quant_ms_%d" % c] = dev_ms(lambda: quant(coefs, bd, qs))
        lay["blob_ms_%d" % c] = dev_ms(lambda: blob(vs[c]))
        lay["slots_ms_%d" % c] = dev_ms(
            lambda: scan_pl.vk_chain_inputs(segs, vs[c]))
        lay["vk_ms_%d" % c] = dev_ms(lambda: scan_pl.vk_chain(*vk_in))
        _, calls = capture_scatter(lambda: blob(vs[c]))
        assert len(calls) == 1, len(calls)
        scatter.append(dict(plane=c, **scatter_study(*calls[0])))
        del calls
    emit("layers", frames=CHUNK, **lay)
    emit("scatter", planes=scatter)

    # torch.profiler over the 32-frame main path
    def run():
        e = cli.make_encoder(meta, cli.default_enc_opts(qp=QP, gop=0),
                             device=dev)
        out = batch.encode_intra_batch(e, frames, chunk=CHUNK)
        out += e.end_of_stream()
        return b"".join(out)

    want = golden.load()[golden.key(golden.FHD, QP)]
    assert golden.digest(run())["sha256"] == want["sha256"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        data = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert golden.digest(data)["sha256"] == want["sha256"]
    busy_ms, by_name = kernel_busy_ms(prof)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "torch_profile_table.txt")
    with open(path, "w") as f:
        f.write(smi + "\n")
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60,
            max_name_column_width=90))
    emit("profile", frames=NFRAMES, wall_ms=wall * 1e3,
         device_busy_ms=busy_ms, busy_share=busy_ms / (wall * 1e3),
         top=[dict(name=n[:90], ms=ms, share=ms / busy_ms)
              for n, ms in by_name[:10]],
         table=os.path.relpath(path, REPO))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
