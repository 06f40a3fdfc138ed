#!/usr/bin/env python3
"""Where the torch port's FHD intra encode spends its time, on one GPU.

    python3 tools/torch_profile.py [--out DIR] [--wavefront | --phases |
                                    --hme [--src CSRC ...]
                                    [--hme-levels all|upper|base] |
                                    --vk [--src CSRC ...] |
                                    --lockstep [--pkg ROOT ...]
                                    [--profile] |
                                    --idle-spans [--idle-trace PATH] |
                                    --scan [--pkg ROOT ...] |
                                    --probe [--src CSRC ...]]

Input: the seeded synthetic clip of chip_smoke.py's main path (1920x1080
4:2:0, 32 frames, -qp=60 -gop=0, chunk 16). Prints one JSON line each:

  layers   device ms of each layer of one 16-frame chunk (CUDA events,
           mean of 5 runs after a warm-up): HVS analysis; forward SBT,
           quantize and scan blob per plane; inside the scan blob, the
           slot compaction and the vk kernel. Also the whole chunk's
           device pass, the host time to enqueue it, and peak device
           memory of one chunk.
  profile  torch.profiler over one 32-frame encode_intra_batch (after a
           warm run): host wall time, device time as the union of the
           kernel and copy intervals, the busy share with the profiler
           on, and the ten kernels with the most device time. The full
           table goes to DIR/torch_profile_table.txt.

With --wavefront it prints only:

  wavefront  the in-loop filter kernel (csrc/wavefront_filter.cu) per
           kind on seeded planes (tools/torch_port_golden.filter_case) at
           FHD 4:2:0 (luma, intra; chroma with 8x8 blocks), 3840x2160
           luma, and 2560x1440 and 3840x2160 4:4:4 chroma: device ms (CUDA
           events, mean of 5 launches after a warm-up) on every cluster
           size the layout takes, the plan, and whether the result equals
           the native C filters.

With --phases it prints only:

  wavefront_phases  clock cycles per diagonal that each warp of CTA 0
           spends in each phase of the filter kernel (next diagonal's
           loads issued, columns written back, window copies, steps,
           first barrier, lane write-backs, next columns stored, second
           barrier), from a copy of csrc/wavefront_filter.cu with clock64
           stamps added, built under build/torch_profile/, on the planes
           of --wavefront at FHD and 2560x1440 4:4:4.

With --hme it prints only:

  hme_phases  the base-level motion search (kernel 5 on the FHD level 0
           of P frames 1 and 2 of chip_smoke.py's P encode; kernel 7 on
           8 seeded CIF lanes with temporal candidates, as chip_smoke.py's
           phase hme_gang_vs_plain): the unstamped kernel's device ms
           (CUDA events, mean of 3 launches after a warm-up; with the
           dataflow scheduler, for several worker counts), and the clock
           cycles per block that the search spends in each phase
           (features, candidates, refine, subpel, decisions, intra tests,
           the block's writes, and the wait before a block: the ticket
           and the neighbours' flags under the scheduler, the barrier
           between diagonals in the one-CTA walk), summed over every warp
           and divided by the blocks, from copies of the sources with
           clock64 stamps added by lane 0 of each warp. Each --src CSRC
           (repeatable, run in the order given) takes the kernel sources
           from a checkout's dsv2_tpu_torch/csrc (the parent's and this
           one's in turns, to compare); the upper levels that feed level 0
           always run this checkout's kernels 4/6, which equal any
           correct version's. The builds go under build/torch_profile/.
  hme_upper_phases  the upper levels (kernel 4 at every upper level of
           FHD P frames 1 and 2; kernel 6 at every upper level of the 8
           CIF lanes, G = 1), each source in turn: device ms per level
           (the default workers and, under the dataflow scheduler, a sweep
           of worker counts), and clock cycles per block in each phase of
           the block (claim: the ticket and the lane switch, or the next
           block of a diagonal in the one-CTA walk; pre: block_pre; wait:
           the neighbours' flags, or the barrier between diagonals; post:
           block_post and the writes), summed over every warp and divided
           by the level's blocks, with the stamped launch's ms. The inputs
           (parent field, global motion) come from this checkout's
           kernels. --hme-levels picks the upper levels, the base level
           or both (default).

With --vk it prints only:

  vk_case  the vk chain's inputs: the FHD chunk's luma, U and V chains
           (16 frames, B = 16), P frame 1's luma plane at B = 1 of the
           FHD P encode and of the CIF fixture, and two synthetic B = 16
           cases that bound the resolve pass (thr = 0: every chunk meets
           a candidate; thr = 2^30: a climb none meets); live rows and
           the plain version's host ms.
  vk_kernel  per source directory of --src in turn (the parent's and
           this one's in turns, to compare; the parent's one-warp source
           is recognised by its arguments): device ms per raw launch of
           csrc/vk_chain.cu (CUDA events, mean of 10 after a warm-up) and
           equality with the plain version; for the chunked design also
           ms per pass (pass 2 as passes 1+2 less pass 1: it rewrites
           pass 1's output) and the resolve pass's counters.
  vk_sweep  FHD luma, FHD P luma and the CIF lane over chunk lengths
           128-2048, warm-ups 0-512 and 64-256 walkers per block: ms,
           the share of chunks met at their first row, rows re-walked.

With --lockstep it prints only, for each --pkg ROOT (a checkout root
holding dsv2_tpu_torch/, each run in a process of its own in the order
given: the parent's and this one's in turns, to compare; default this
checkout):

  lockstep  the 8 corrupt-stream trials of chip_smoke.py's
           decode_corrupt (pictures one at a time) and the committed CIF
           -gop=12 P stream (chunked chain steps), decoded against their
           goldens: fps of each of 3 timed runs after a warm one;
           the lockstep cell of chip_smoke.py (the seeded CIF clip as 8
           lanes of 48 frames at -qp=60 -gop=48, width 8, gang motion
           search, after a warm run; every lane against its golden
           digest): fps, and the lockstep.dispatch and lockstep.run
           seconds by key; where the package has parallel/gop.py, the
           lockstep decode of the 8 lanes' stream (width 8): fps,
           decode.parse and dispatch seconds. With --profile also the
           device busy share of the lockstep encode and decode under
           torch.profiler (union of the kernel and copy intervals over
           host wall time, the profiler on).

With --idle-spans it prints only, for one job of each of the benchmark's
cells cif_lockstep_encode_x8 and fhd_intra_encode (codecbench/; seed 7),
each run after a warm job in a process of its own under DSV2_TRACE=1
DSV2_XPROF (a Chrome trace of every thread; under build/torch_profile/):

  idle_spans  the card's idle time in the job: the gaps between its
           kernels, copies and sets (the idle head before the first and
           tail after the last apart), each named by the innermost port
           span open across it (utils/trace spans, which DSV2_XPROF puts
           on each thread's row as record_function ranges; the shortest
           that covers the gap, over every thread) and, per thread, by
           that thread's innermost span; the gaps longer than 1 ms, those
           inside no port span, and the longest gaps. With --idle-trace
           PATH it reads that trace instead (`idle_by_span`).

With --probe it prints only:

  probe_plain  the plain version of the gang cost probe (kernel 8) on the
           card, full mode (CUDA events, mean of 10 after a warm-up).
  probe_kernel  per source directory of --src in turn (the parent's and
           this one's in turns, to compare; the parent's one-warp source
           is recognised by its arguments): device ms (CUDA events, mean
           of 20 after a warm-up) and ns per evaluation of every probe
           (block, gang x full, read, compute) at NB = 704, EVALS = 16, on
           the whole card (w0: launch_shape's default) and as one walker
           (w1; the parent's only shape); equality with the plain
           versions; ms of the full probes at 1, 4, 16 and 64 evaluations
           (evaluations that were hoisted or folded would not add time);
           ptxas's registers and spills, and per kernel function the
           SASS instructions of some opcodes (shared and global loads,
           shuffles, branches; cuobjdump -sass, whose whole listing goes
           to DIR/probe_sass_<source>.txt).

With --scan it prints only, for each --pkg ROOT (a checkout root holding
dsv2_tpu_torch/, each run in a process of its own in the order given: the
parent's and this one's in turns, to compare; default this checkout), on
the first 16-frame chunk of the fhd_intra_encode cell's clip
(codecbench/; 1920x1080 4:2:0, -qp=60, seed 7; `--scan-seed`):

  scan_chunk  per plane: the share of nonzero scan values, the scan
           blob's device ms (make_scan_blob, CUDA events, mean of 10
           after a warm-up) and host enqueue ms, and each scatter it
           issues timed alone (aten scatter_ and scatter_add_, captured
           as issued and replayed into a copy of their output; mean of
           10), with the share of the scatter's writes that land on its
           most written element; and SHA-256 of every row's blob bytes
           [0, nbytes), nbytes and fallback (equal across roots: the
           bytes did not change).
  scan_job  torch.profiler over one 32-frame encode_intra_batch of the
           cell's clip (after a warm job): device ms under
           aten::scatter_add_ per frame, split by output shape into the
           scan blob's emission ((16, words + 1) int64) and the HVS
           analysis' histograms, and under aten::scatter_.

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


def wavefront_study():
    """Time the filter wavefront kernel per kind, layout and cluster."""
    import torch
    import torch_port_golden as golden
    from dsv2_tpu_torch.ops import _kernels, filters

    dev = torch.device("cuda")
    for kind, w, h, blk, shifts in (
            ("luma", 1920, 1080, 32, (1, 1)), ("intra", 1920, 1080, 32,
                                                (1, 1)),
            ("chroma", 1920, 1080, 16, (1, 1)),
            ("luma", 3840, 2160, 32, (1, 1)),
            ("chroma", 2560, 1440, 32, (0, 0)),
            ("chroma", 3840, 2160, 32, (0, 0))):
        args = golden.filter_case(kind, w, h, blk, shifts, seed=w, nb=1)
        want = golden.filter_native(kind, args)
        calls = []
        wf = filters.wavefront_filter

        def rec(kind_, lay, plane, props, scal):
            calls.append((lay, plane.clone(), props, scal))
            return wf(kind_, lay, plane, props, scal)
        filters.wavefront_filter = rec
        try:
            got = getattr(filters, kind + "_filter_graph")(
                *(a.to(dev) if isinstance(a, torch.Tensor) else a
                  for a in args))
        finally:
            filters.wavefront_filter = wf
        (lay, src, props, scal), = calls
        plan = filters.wavefront_plan(lay, max_smem=_kernels.max_smem())
        work = src.clone()
        ms = {}
        for c in filters.WF_CLUSTERS:
            try:
                filters.wavefront_plan(lay, c, _kernels.max_smem())
            except ValueError:
                continue

            def run(c=c):
                work.copy_(src)
                _kernels.wavefront_filter(filters.KINDS.index(kind), lay,
                                          work, props, scal, cluster=c)
            ms[c] = dev_ms(run)
        emit("wavefront", kind=kind, plane=[lay.pw, lay.ph],
             tile=[lay.tw, lay.th], diagonals=lay.nd, lanes=lay.L,
             plan=plan._asdict(), ms_by_cluster=ms, ms=ms[plan.C],
             us_per_diagonal=1e3 * ms[plan.C] / lay.nd,
             equal_native=bool(torch.equal(got.cpu(), want)),
             device=torch.cuda.get_device_name(0))


PHASES = ("pf_issue", "leave_wb", "copy", "step", "bar1", "writeback",
          "pf_store", "bar2")


def _stamped_source():
    """csrc/wavefront_filter.cu with a clock64 stamp at the end of each
    phase (acc_[k] gathers the cycles since the previous stamp), written
    by each warp's first thread of CTA 0 to g_prof at the end."""
    from dsv2_tpu_torch.ops import _kernels
    with open(os.path.join(_kernels.CSRC, "wavefront_filter.cu")) as f:
        src = f.read()

    def stamp(k):
        return ("{ unsigned long long now_ = clock64(); acc_[%d] += now_ - "
                "last_; last_ = now_; }\n" % k)
    edits = [  # (anchor, text, after the anchor?)
        ("namespace {\n", "__device__ unsigned long long g_prof[16 * 8];\n",
         False),
        ("  uint32_t pf[kPrefetch];\n", "  unsigned long long acc_[8] = {};"
         " unsigned long long last_ = clock64();\n", True),
        ("    const int sin = s0 + 3 * tw + 8;\n", "    " + stamp(0), True),
        ("    const int j0 = first_lane(g, d, jlo);\n", "    " + stamp(1),
         False),
        ("      if constexpr (KIND == kIntra) intra_step", "      " + stamp(2),
         False),
        ("      if constexpr (KIND == kChroma) chroma_step(W, g, pr, i, j, "
         "sc);\n", "      " + stamp(3), True),
        ("    front_sync<CL>();   // every window of diagonal d is read\n",
         "    " + stamp(4), True),
        ("    if (next) {\n      // the columns of diagonal d+1 into",
         "    " + stamp(5), False),
        ("    front_sync<CL>();   // diagonal d is in the ring\n",
         "    " + stamp(6), False),
        ("    front_sync<CL>();   // diagonal d is in the ring\n",
         "    " + stamp(7), True),
        ("  // the last strip back to the plane", "  if ((tid & 31) == 0 && "
         "blockIdx.x == 0) for (int q = 0; q < 8; ++q) g_prof[(tid >> 5) * 8"
         " + q] = acc_[q];\n", False)]
    for anchor, text, after in edits:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, anchor + text if after else text + anchor)
    return src + ('\nextern "C" int dsv2t_prof_read(unsigned long long* o) '
                  '{\n  return (int)cudaMemcpyFromSymbol(o, g_prof, '
                  'sizeof(g_prof));\n}\n')


def wavefront_phases():
    """Cycles per diagonal of each phase of the filter kernel, per warp of
    CTA 0, on the --wavefront planes."""
    import ctypes
    import numpy as np
    import torch
    import torch_port_golden as golden
    from dsv2_tpu_torch.ops import _kernels, filters

    out = os.path.join(REPO, "build", "torch_profile")
    os.makedirs(out, exist_ok=True)
    cu, so = (os.path.join(out, "wf_phases" + e) for e in (".cu", ".so"))
    with open(cu, "w") as f:
        f.write(_stamped_source())
    subprocess.run([_kernels._nvcc()] + _kernels.NVCC_FLAGS + ["-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fn, rd = lib.dsv2t_wavefront_filter, lib.dsv2t_prof_read
    fn.restype = rd.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    rd.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    for kind, w, h, blk, shifts in (
            ("luma", 1920, 1080, 32, (1, 1)), ("intra", 1920, 1080, 32,
                                                (1, 1)),
            ("chroma", 1920, 1080, 16, (1, 1)),
            ("chroma", 2560, 1440, 32, (0, 0))):
        args = golden.filter_case(kind, w, h, blk, shifts, seed=w, nb=1)
        calls = []
        wf = filters.wavefront_filter

        def rec(kind_, lay, plane, props, scal):
            calls.append((lay, plane.clone(), props, scal))
            return wf(kind_, lay, plane, props, scal)
        filters.wavefront_filter = rec
        try:
            getattr(filters, kind + "_filter_graph")(
                *(a.to(dev) if isinstance(a, torch.Tensor) else a
                  for a in args))
        finally:
            filters.wavefront_filter = wf
        (lay, src, props, scal), = calls
        plan = filters.wavefront_plan(lay, max_smem=_kernels.max_smem())
        geom = _kernels.wavefront_geom(lay, props.shape[1], plan)
        for _ in range(2):
            work = src.to(torch.uint8)
            rc = fn(filters.KINDS.index(kind), work.data_ptr(),
                    props.data_ptr(), scal.data_ptr(), 1, geom.ctypes.data,
                    torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            assert rc == 0, rc
        buf = np.zeros(16 * 8, np.uint64)
        assert rd(buf.ctypes.data) == 0
        per = buf[:plan.threads // 32 * 8].reshape(-1, 8) / lay.nd
        emit("wavefront_phases", kind=kind, plane=[lay.pw, lay.ph],
             tile=[lay.tw, lay.th], diagonals=lay.nd, plan=plan._asdict(),
             cycles_per_diagonal_warp0=dict(zip(PHASES, per[0].tolist())),
             cycles_per_diagonal_last_warp=dict(zip(PHASES,
                                                    per[-1].tolist())),
             cycles_per_diagonal_max=dict(zip(PHASES,
                                              per.max(0).tolist())),
             device=torch.cuda.get_device_name(0))


HME_PHASES = ("features", "candidates", "refine", "subpel", "decisions",
              "intra", "writes", "wait")
_HME_PRELUDE = r"""
#define HME_PROF_WARPS 4096
__device__ unsigned long long g_prof[HME_PROF_WARPS * 8];
__device__ unsigned long long g_last[HME_PROF_WARPS];
#define HME_WARP() ((blockIdx.x * blockDim.x + threadIdx.x) >> 5)
#define HME_STAMP(k) { if ((threadIdx.x & 31) == 0 && HME_WARP() < \
    HME_PROF_WARPS) { unsigned long long n_ = clock64(); \
    g_prof[HME_WARP() * 8 + (k)] += n_ - g_last[HME_WARP()]; \
    g_last[HME_WARP()] = n_; } }
"""
_HME_READ = r"""
extern "C" int dsv2t_prof_read(unsigned long long* o) {
  static unsigned long long z[HME_PROF_WARPS * 8];
  cudaError_t e = cudaMemcpyFromSymbol(o, g_prof, sizeof(g_prof));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, z, sizeof(g_prof));
  return (int)e;
}
"""


def _hme_stamped(src_dir, out_dir):
    """Copies of src_dir's motion-search sources under out_dir with a
    clock64 stamp closing each phase of HME_PHASES (anchors for the
    one-CTA walk and for the dataflow version, whose search is split
    around the wait for the neighbours: its "subpel" also counts the
    first subpel probes before the wait); returns True if the sources
    have the dataflow scheduler."""
    import re
    import shutil
    dag = os.path.exists(os.path.join(src_dir, "hme_sched.cuh"))
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(src_dir, f), out_dir)

    def stamp(k):
        return "    HME_STAMP(%d)\n" % k
    tail = [  # phases after the search, the same lines in both versions
        (r"    const int mvx = fpelx \* 4 \+ sub_x, mvy = fpely \* 4 "
         r"\+ sub_y;\n", stamp(3), True),
        (r"    // luma intra subblock test", stamp(4), False),
        (r"    bool intra = submask != 0;\n", stamp(5), True),
        (r"    st\[3\] \+= intra;\n", stamp(6), True)]
    if dag:  # search split around the wait for the neighbours
        block = [
            (r"    // candidates \(ref: hme.c:1443-1528\), in slot order",
             stamp(0), False),
            (r"    return true;\n  }\n\n  // The (rest of the search|first "
             r"strict minimum)", stamp(1), False),
            (r"    // good-enough vs the source reference", stamp(1), False),
            (r"\n    wait\(\);\n", "\n" + stamp(3), False),
            (r"    wait\(\);\n", stamp(7), True),
            (r"(?m)^    block_post\(g, L, i, j, sw, r, c\);\n", stamp(2),
             True)]
    else:  # the one-CTA walk: search, then a barrier per diagonal
        block = [
            (r"    // median predictor \(ref: dsv.c:373-400\)\n", stamp(0),
             False),
            (r"    // good-enough vs the source reference", stamp(1), False),
            (r"    if \(!block_search\([^\n]*\)\) return;\n", stamp(2),
             True),
            (r"    __syncthreads\(\);  // diagonal d is in the grids\n",
             stamp(7), True)]
    edits = {"hme_block.cuh": block + tail}
    for name in ("hme_search.cu", "hme_gang.cu"):
        edits[name] = [(r"  extern __shared__ __align__\(16\) uint8_t "
                        r"smem\[\];\n", "  if ((threadIdx.x & 31) == 0 && "
                        "HME_WARP() < HME_PROF_WARPS) g_last[HME_WARP()] = "
                        "clock64();\n", True)]
    for name, eds in edits.items():
        if not eds:
            continue
        path = os.path.join(out_dir, name)
        with open(path) as f:
            src = f.read()
        for anchor, text, after in eds:
            src, n = re.subn(anchor, (lambda m: m.group(0) + text) if after
                             else (lambda m: text + m.group(0)), src)
            assert n >= 1, (name, anchor)
        if name.endswith(".cu"):
            src = _HME_PRELUDE + src + _HME_READ
        with open(path, "w") as f:
            f.write(src)
    return dag


HME_UPPER_PHASES = ("claim", "pre", "wait", "post")


def _upper_dataflow(src_dir):
    """True if src_dir's upper levels run on the dataflow scheduler."""
    with open(os.path.join(src_dir, "hme_block.cuh")) as f:
        return "upper_dag" in f.read()


def _hme_upper_stamped(src_dir, out_dir):
    """Copies of src_dir's motion-search sources under out_dir with a
    clock64 stamp closing each phase of HME_UPPER_PHASES in the upper
    levels' driver (upper_dag, or the one-CTA walk_level)."""
    import re
    import shutil
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(src_dir, f), out_dir)

    def stamp(k):
        return "      HME_STAMP(%d)\n" % k
    if _upper_dataflow(src_dir):
        block = [
            (r"    const int step = 1 << g.level, i = a \* step, "
             r"j = b \* step;\n", stamp(0), True),
            (r"    const bool in = T::block_pre\(g, L, i, j, buf, r, sw, "
             r"c(, false)?\);\n", stamp(1), True),
            (r"    wait\(\);\n(?=    if \(!in\) return;\n    T::block_post)",
             stamp(2), True),
            (r"      L.out\[g.nbv \* g.nbh \+ j \* g.nbh \+ i\] = "
             r"r.dy \* step;\n    }\n", stamp(3), True)]
    else:
        block = [
            (r"      const int i = a \* step, j = b \* step;\n", stamp(0),
             True),
            (r"      if \(T::block_pre\(g, L, i, j, buf, r, sw, c, "
             r"true\)\) \{\n", stamp(1), True),
            (r"        T::block_post\(g, L, i, j, sw, r, c\);\n", stamp(3),
             True),
            (r"    __syncthreads\(\);  // diagonal d is in the grids\n",
             stamp(2), True)]
    edits = {"hme_block.cuh": [e + (1,) for e in block]}
    for name in ("hme_search.cu", "hme_gang.cu"):
        edits[name] = [(r"  extern __shared__ __align__\(16\) uint8_t "
                        r"smem\[\];\n", "  if ((threadIdx.x & 31) == 0 && "
                        "HME_WARP() < HME_PROF_WARPS) g_last[HME_WARP()] = "
                        "clock64();\n", True, 2)]
    for name, eds in edits.items():
        path = os.path.join(out_dir, name)
        with open(path) as f:
            src = f.read()
        for anchor, text, after, want in eds:
            src, n = re.subn(anchor, (lambda m: m.group(0) + text) if after
                             else (lambda m: text + m.group(0)), src)
            assert n == want, (name, anchor, n)
        if name.endswith(".cu"):
            src = _HME_PRELUDE + src + _HME_READ
        with open(path, "w") as f:
            f.write(src)


def _hme_lib(src_dir, out_dir, stamped):
    """Build hme_search.cu and hme_gang.cu of src_dir (stamped copies if
    asked: "base" stamps the base level's phases, "upper" the upper
    levels') under out_dir; returns ({name: CDLL}, dataflow?)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from dsv2_tpu_torch.ops import _kernels
    if stamped == "upper":
        _hme_upper_stamped(src_dir, out_dir)
        dag = _upper_dataflow(src_dir)
        src_dir = out_dir
    elif stamped:
        dag = _hme_stamped(src_dir, out_dir)
        src_dir = out_dir
    else:
        dag = os.path.exists(os.path.join(src_dir, "hme_sched.cuh"))
    os.makedirs(out_dir, exist_ok=True)

    def build(name):
        so = os.path.join(out_dir, "lib%s%s.so" % (name, "_st" * bool(
            stamped)))
        subprocess.run([_kernels._nvcc()] + _kernels.NVCC_FLAGS
                       + ["-o", so, os.path.join(src_dir, name + ".cu")],
                       check=True, capture_output=True)
        return name, ctypes.CDLL(so)
    with ThreadPoolExecutor(2) as ex:
        return dict(ex.map(build, ("hme_search", "hme_gang"))), dag


def _hme_inputs(dev):
    """Launches to study: (level-0 cases, upper cases). Level 0:
    ("fhd_p_frameN", cfg, lanes) for FHD P frames 1 and 2 and ("cif_x8",
    cfg, lanes) for 8 seeded CIF lanes; a lane is (planes, chroma, parent,
    tmv, gxy, quant, skip_thresh), the parent field and global motion from
    this checkout's upper-level kernels. Upper: (label, cfg, level, lanes)
    for every upper level of the same inputs, a lane (planes, parent, tmv,
    gxy, quant)."""
    import torch
    import torch_port_golden as golden
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.ops import hme_gang, hme_gpu, hme_wave

    frames, meta = cli.read_y4m(golden.input_path(golden.FHD))
    recorded = []
    make_me = hme_gpu.make_motion_est

    def recording(cfg):
        fn = make_me(cfg)

        def f(*inputs):
            recorded.append((cfg, inputs))
            return fn(*inputs)
        return f
    hme_gpu.make_motion_est = recording
    try:
        golden.encode(cli, frames[:3], meta, 60, gop=8, device=dev)
    finally:
        hme_gpu.make_motion_est = make_me
    del frames
    cases, upper = [], []
    for n, (cfg, inp) in enumerate(recorded):
        sp, rp, op, su, sv, ru, rv, tmx, tmy, quant, skt = inp
        tmv = torch.stack([tmx, tmy]).contiguous()
        gxy = torch.zeros(2, dtype=torch.int32, device=dev)
        parent = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=torch.int32,
                             device=dev)
        for level in range(cfg.pyramid_levels, 0, -1):
            upper.append(("fhd_p_frame%d" % (n + 1), cfg, level, [
                ((sp[level], rp[level], op[level]), parent, tmv, gxy,
                 int(quant))]))
            parent = hme_gpu.hme_level(cfg, level, sp[level], rp[level],
                                       op[level], parent, tmv, gxy,
                                       int(quant))
            gxy = torch.stack(hme_wave.global_motion_graph(
                cfg, level, parent[0], parent[1]))
        cases.append(("fhd_p_frame%d" % (n + 1), cfg, [
            ((sp[0], rp[0], op[0]), (su, sv, ru, rv), parent, tmv, gxy,
             int(quant), int(skt))]))
    cif, cmeta = cli.read_y4m(golden.input_path("cif352x288_420_12f"))
    cfgd, lanes = golden.hme_lanes(cif, cmeta, 8, has_tmv=True, device=dev)
    cfg = hme_wave.WaveCfg(**cfgd)
    n = len(lanes)
    tmv = torch.stack([torch.stack([ln[7], ln[8]]) for ln in lanes]
                      ).contiguous()
    quants = [int(ln[9]) for ln in lanes]
    gxy = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    parent = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=torch.int32,
                         device=dev)
    for level in range(cfg.pyramid_levels, 0, -1):
        upper.append(("cif_x8", cfg, level, [
            ((ln[0][level], ln[1][level], ln[2][level]), parent[i], tmv[i],
             gxy[i], quants[i]) for i, ln in enumerate(lanes)]))
        parent = hme_gpu.hme_gang_level(
            cfg, level, [ln[0][level] for ln in lanes],
            [ln[1][level] for ln in lanes], [ln[2][level] for ln in lanes],
            parent, tmv, gxy, quants)
        gxy = hme_gang.global_motion_lanes(cfg, level, parent)
    cases.append(("cif_x8", cfg, [
        ((ln[0][0], ln[1][0], ln[2][0]), tuple(ln[3:7]), parent[i], tmv[i],
         gxy[i], quants[i], int(ln[10])) for i, ln in enumerate(lanes)]))
    return cases, upper


def _hme_launcher(libs, dag, cfg, lanes, dev):
    """fn(workers) -> one level-0 launch of `lanes` through libs (kernel 5
    for one lane, kernel 7 for several), on fresh zeroed outputs; the
    parent's ABI (no scheduler) when not dag."""
    import ctypes
    import numpy as np
    import torch
    from dsv2_tpu_torch.ops import hme_gpu
    P, I = ctypes.c_void_p, ctypes.c_int
    n = len(lanes)
    out = torch.zeros((n, hme_gpu.NF0, cfg.nbv, cfg.nbh), dtype=torch.int32,
                      device=dev)
    sums = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    sched = torch.zeros(1 + n * cfg.nbv * cfg.nbh, dtype=torch.int32,
                        device=dev)
    (planes, chroma, _, _, _, q0, s0) = lanes[0]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())
    if n == 1:
        fn = libs["hme_search"].dsv2t_hme_level0
        fn.restype = I
        fn.argtypes = [P] * 13 + [I, P, P] if dag else [P] * 14
        geom = hme_gpu.geometry(cfg, 0, [planes[0]], list(chroma), q0, s0)
        _, _, parent, tmv, gxy, _, _ = lanes[0]
        args = [ptr(t) for t in planes + chroma + (parent, tmv, gxy, out[0],
                                                   sums[0])]

        def run(workers=0):
            out.zero_()
            sums.zero_()
            sched.zero_()
            extra = [ptr(sched), workers] if dag else []
            assert fn(*args, *extra, geom.ctypes.data, stream) == 0
    else:
        fn = libs["hme_gang"].dsv2t_hme_gang
        fn.restype = I
        fn.argtypes = [I, I, I, P, P, P] + ([P, I] if dag else []) + [P]
        # the stacked grids stay referenced: the launch reads them
        grids = [torch.stack([ln[k] for ln in lanes]) for k in (2, 3, 4)]
        geom, ptrs, scal = hme_gpu._gang_args(
            cfg, 0, [(list(ln[0]), list(ln[1])) for ln in lanes], *grids,
            out, sums, [ln[5] for ln in lanes], [ln[6] for ln in lanes], 1)
        keep = (ptrs, scal, geom, grids)

        def run(workers=0):
            out.zero_()
            sums.zero_()
            sched.zero_()
            extra = [ptr(sched), workers] if dag else []
            assert fn(1, 32, n, keep[2].ctypes.data, keep[0].ctypes.data,
                      keep[1].ctypes.data, *extra, stream) == 0
    return run, out, sums


def _hme_upper_launcher(libs, dag, cfg, level, lanes, dev):
    """fn(workers) -> one upper-level launch of `lanes` through libs
    (kernel 4 for one lane, kernel 6 at G = 1 for several) on a fresh
    zeroed output; the parent's ABI (no scheduler at the upper levels)
    when not dag."""
    import ctypes
    import torch
    from dsv2_tpu_torch.ops import hme_gpu
    P, I = ctypes.c_void_p, ctypes.c_int
    n = len(lanes)
    out = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=torch.int32,
                      device=dev)
    sched = hme_gpu._sched(cfg, n, dev, level)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())
    if n == 1:
        fn = libs["hme_search"].dsv2t_hme_level
        fn.restype = I
        fn.argtypes = [P] * 8 + [I, P, P] if dag else [P] * 9
        planes, parent, tmv, gxy, quant = lanes[0]
        geom = hme_gpu.geometry(cfg, level, [planes[0]], [], quant, 0)
        args = [ptr(t) for t in planes + (parent, tmv, gxy, out[0])]

        def run(workers=0):
            out.zero_()
            sched.zero_()
            extra = [ptr(sched), workers] if dag else []
            assert fn(*args, *extra, geom.ctypes.data, stream) == 0
    else:
        fn = libs["hme_gang"].dsv2t_hme_gang
        fn.restype = I
        fn.argtypes = [I, I, I, P, P, P, P, I, P]
        grids = [torch.stack([ln[k] for ln in lanes]) for k in (1, 2, 3)]
        geom, ptrs, scal = hme_gpu._gang_args(
            cfg, level, [(list(ln[0]), []) for ln in lanes], *grids, out,
            None, [ln[4] for ln in lanes], [0] * n, 1)
        keep = (ptrs, scal, geom, grids)

        def run(workers=0):
            out.zero_()
            sched.zero_()
            assert fn(0, 32, n, keep[2].ctypes.data, keep[0].ctypes.data,
                      keep[1].ctypes.data, ptr(sched), workers, stream) == 0
    return run, out


def _read_prof(libs, n, run):
    """Cycles per stamp slot summed over the warps of one stamped launch
    run() (after a warm-up launch), and that launch's device ms."""
    import ctypes
    import numpy as np
    import torch
    rd = libs["hme_gang" if n > 1 else "hme_search"].dsv2t_prof_read
    rd.restype = ctypes.c_int
    rd.argtypes = [ctypes.c_void_p]
    buf = np.zeros(4096 * 8, np.uint64)
    run()
    torch.cuda.synchronize()
    assert rd(buf.ctypes.data) == 0   # reset after the warm-up
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    assert rd(buf.ctypes.data) == 0
    return buf.reshape(-1, 8), t0.elapsed_time(t1)


UPPER_WORKERS = (16, 34, 66, 132, 264, 528)


def hme_study(srcs, levels="all"):
    """Kernel ms and cycles per phase of the motion search of each source
    directory of `srcs` in turn, the base level and/or the upper levels
    (see the module docstring, --hme); a directory named twice is built
    once."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    tags = {d: os.path.relpath(os.path.abspath(d), REPO) for d in srcs}

    kinds = [("plain", False)] + [(k, k) for k in ("base", "upper")
                                   if levels in ("all", k)]

    def build(job):
        d, (sub, stamped) = job
        base = os.path.join(REPO, "build", "torch_profile",
                            "hme_" + tags[d].replace(os.sep, "_"))
        return (d, sub), _hme_lib(d, os.path.join(base, sub), stamped)
    with ThreadPoolExecutor(len(tags) * len(kinds)) as ex:
        libs = dict(ex.map(build, [(d, k) for d in tags for k in kinds]))
    cases, upper = _hme_inputs(dev)
    for d in srcs:
        if levels in ("all", "upper"):
            _upper_study(d, tags[d], libs[d, "plain"][0], libs[d, "upper"],
                         upper, dev, smi)
        if levels == "upper":
            continue
        plain_libs, dag = libs[d, "plain"]
        st_libs = libs[d, "base"][0]
        for label, cfg, lanes in cases:
            run, out, sums = _hme_launcher(plain_libs, dag, cfg, lanes, dev)
            ms = {"default": dev_ms(run, 3)}
            want = (out.clone(), sums.clone())
            if dag:
                for w in (132, 264, 528, 1056, 2112):
                    ms[w] = dev_ms(lambda w=w: run(w), 3)
                    assert torch.equal(out, want[0])
                    assert torch.equal(sums, want[1])
            srun, sout, ssums = _hme_launcher(st_libs, dag, cfg, lanes, dev)
            buf, stamped_ms = _read_prof(st_libs, len(lanes), srun)
            assert torch.equal(sout, want[0]) and torch.equal(ssums, want[1])
            blocks = len(lanes) * cfg.nbv * cfg.nbh
            per = buf.sum(0) / blocks
            emit("hme_phases", case=label, source=tags[d], dataflow=dag,
                 lanes=len(lanes), blocks=blocks,
                 diagonals=cfg.nbv + cfg.nbh - 1, ms_by_workers=ms,
                 stamped_ms=stamped_ms,
                 cycles_per_block=dict(zip(HME_PHASES, per.tolist())),
                 busy_cycles_per_block=float(per[:7].sum()),
                 warps_stamped=int((buf.sum(1) > 0).sum()),
                 nvidia_smi=smi)


def _upper_study(d, tag, plain_libs, stamped, upper, dev, smi):
    """hme_upper_phases of source directory d (see hme_study)."""
    import torch
    from dsv2_tpu_torch.ops import hme_wave
    st_libs, dag = stamped
    for label, cfg, level, lanes in upper:
        run, out = _hme_upper_launcher(plain_libs, dag, cfg, level, lanes,
                                       dev)
        ms = {"default": dev_ms(run, 3)}
        want = out.clone()
        if dag:
            for w in UPPER_WORKERS:
                ms[w] = dev_ms(lambda w=w: run(w), 3)
                assert torch.equal(out, want)
        srun, sout = _hme_upper_launcher(st_libs, dag, cfg, level, lanes,
                                         dev)
        buf, stamped_ms = _read_prof(st_libs, len(lanes), srun)
        assert torch.equal(sout, want)
        _, ca, cb, nd = hme_wave.lane_grid(cfg, level)
        blocks = len(lanes) * ca * cb
        per = buf.sum(0)[:len(HME_UPPER_PHASES)] / blocks
        emit("hme_upper_phases", case=label, level=level, source=tag,
             dataflow=dag, lanes=len(lanes), blocks=blocks, diagonals=nd,
             ms_by_workers=ms, stamped_ms=stamped_ms,
             cycles_per_block=dict(zip(HME_UPPER_PHASES, per.tolist())),
             warps_stamped=int((buf.sum(1) > 0).sum()), nvidia_smi=smi)


def _vk_lib(src_dir, out_dir):
    """Build src_dir/vk_chain.cu under out_dir; returns (C entry, whether it
    takes the chunked design's arguments: scratch, plan, passes, stats)."""
    import ctypes
    from dsv2_tpu_torch.ops import _kernels
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(src_dir, "vk_chain.cu")
    so = os.path.join(out_dir, "libvk_chain.so")
    subprocess.run([_kernels._nvcc()] + _kernels.NVCC_FLAGS + ["-o", so, src],
                   check=True, capture_output=True)
    with open(src) as f:
        chunked = "void* scratch" in f.read()
    fn = ctypes.CDLL(so).dsv2t_vk_chain
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 5 + [I] * 6 + [P, P]) if chunked else (
        [P] * 5 + [I, I, P])
    return fn, chunked


def _vk_inputs(dev):
    """(label, thr, s0, nnz) on the card: the FHD chunk's luma, U and V
    chains (16 frames, B = 16), and B = 1 chains as the P paths launch
    them: the luma plane of FHD P frame 1 (-qp=60 -gop=8) and of CIF P
    frame 1 (cif352x288_420_12f at -qp=60 -gop=12, one lockstep lane's
    plane size); and two synthetic B = 16 cases that bound the resolve
    pass: thr = 0 on 2^21 rows (every chunk's true start meets a
    candidate: the pass is its stream) and thr = 2^30 on 2^17 rows (a
    climb no candidate meets: the pass re-walks every row)."""
    import torch
    import torch_port_golden as golden
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.ops import hzcc, scan_pl
    from dsv2_tpu_torch.parallel import batch
    frames, meta = cli.read_y4m(golden.input_path(golden.FHD))
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=QP, gop=0),
                           device=dev)
    ctx = batch._prep_chunk(enc, frames[:CHUNK])
    p = ctx["p"]
    xs, bds, qs = batch._chunk_inputs(enc, ctx)
    vs = batch._device_batch_fn(meta.width, meta.height, meta.subsamp,
                                p.blk_w, p.blk_h, p.lossless, p.do_psy,
                                ctx["analyze"])(xs[0], xs[1], xs[2], bds,
                                                qs)[2]
    out = [("fhd_%s_chunk" % n, *scan_pl.vk_chain_inputs(tuple(
        hzcc.scan_segments(*ctx["pcfg"].cdims[c])), vs[c]))
           for c, n in ((0, "luma"), (1, "u"), (2, "v"))]
    del vs, xs
    vk = scan_pl.vk_chain
    for label, name, fr, gop in (
            ("fhd_p_luma_b1", golden.FHD, frames[:2], 8),
            ("cif_p_luma_b1", "cif352x288_420_12f", None, 12)):
        if fr is None:
            fr, meta = cli.read_y4m(golden.input_path(name))
            fr = fr[:2]
        calls = []

        def rec(thr, s0, nnz, stats=None):
            calls.append((thr.clone(), s0.clone(), nnz.clone()))
            return vk(thr, s0, nnz, stats)
        scan_pl.vk_chain = rec
        try:
            e = cli.make_encoder(meta, cli.default_enc_opts(qp=QP, gop=gop),
                                 device=dev)
            e.encode_frame(fr[0])
            del calls[:]
            e.encode_frame(fr[1])
        finally:
            scan_pl.vk_chain = vk
        assert all(c[0].shape[1] == 1 for c in calls), "P path B != 1"
        big = max(calls, key=lambda c: c[0].shape[0])
        out.append((label, *big))
    # synthetic: every chunk meets a candidate (thr = 0: vk stays 0), and
    # no chunk ever does (thr far above vk: a climb, re-walked row by row)
    for label, value, npad in (("all_met_b16", 0, 1 << 21),
                               ("climb_b16", 1 << 30, 1 << 17)):
        out.append((label, torch.full((npad, 16), value, dtype=torch.int32,
                                      device=dev),
                    torch.zeros(16, dtype=torch.int32, device=dev),
                    torch.full((16,), npad, dtype=torch.int32, device=dev)))
    return out


def vk_study(srcs):
    """The vk chain kernel of each source directory of `srcs` in turn (see
    the module docstring, --vk)."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from dsv2_tpu_torch.ops import _kernels, scan_pl
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    tags = {d: os.path.relpath(os.path.abspath(d), REPO) for d in srcs}

    def build(d):
        return d, _vk_lib(d, os.path.join(REPO, "build", "torch_profile",
                                          "vk_" + tags[d].replace(os.sep,
                                                                  "_")))
    with ThreadPoolExecutor(len(tags)) as ex:
        libs = dict(ex.map(build, list(tags)))
    cases = _vk_inputs(dev)
    plain = {}
    for label, thr, s0, nnz in cases:
        t0 = time.perf_counter()
        plain[label] = scan_pl.vk_chain_plain(thr, s0, nnz).to(dev)
        emit("vk_case", case=label, npad=thr.shape[0], B=thr.shape[1],
             live_rows=int((nnz - s0).clamp(min=0).sum()),
             plain_ms=(time.perf_counter() - t0) * 1e3)

    def launcher(fn, chunked, thr, s0, nnz, plan=None, passes=7,
                 stats=None):
        npad, nb = thr.shape
        out = torch.empty_like(thr)
        stream = torch.cuda.current_stream().cuda_stream
        if not chunked:
            aux = torch.empty(nb, dtype=torch.int32, device=dev)
            args = (thr.data_ptr(), s0.data_ptr(), nnz.data_ptr(),
                    out.data_ptr(), aux.data_ptr(), npad, nb, stream)
        else:
            chunk, warmup, walkers = plan or _kernels.vk_plan(npad, nb)
            aux = torch.empty(_kernels.vk_scratch_bytes(npad, nb, chunk),
                              dtype=torch.uint8, device=dev)
            args = (thr.data_ptr(), s0.data_ptr(), nnz.data_ptr(),
                    out.data_ptr(), aux.data_ptr(), npad, nb, chunk,
                    warmup, walkers, passes,
                    None if stats is None else stats.data_ptr(), stream)

        def run(p=None):
            a = args if p is None else args[:10] + (p,) + args[11:]
            assert fn(*a) == 0
        return run, out

    for d in srcs:
        fn, chunked = libs[d]
        for label, thr, s0, nnz in cases:
            run, out = launcher(fn, chunked, thr, s0, nnz)
            rec = dict(case=label, source=tags[d], ms=dev_ms(run, 10))
            rec["equal"] = bool(torch.equal(out, plain[label]))
            assert rec["equal"], rec
            if chunked:
                stats = torch.zeros(5, dtype=torch.int32, device=dev)
                srun, sout = launcher(fn, chunked, thr, s0, nnz,
                                      stats=stats)
                srun()
                torch.cuda.synchronize()
                live, met, rewalked, remet, rows = stats.tolist()
                rec.update(chunks=live, met_at_start=met / live,
                           rewalked=rewalked, rewalks_met=remet,
                           rows_rewalked=rows)
                # the passes apart: pass 2 rewrites pass 1's scratch, so
                # it is timed as passes 1+2 less pass 1
                p1 = dev_ms(lambda: run(1), 10)
                p12 = dev_ms(lambda: run(3), 10)
                rec.update(pass1_ms=p1, pass2_ms=p12 - p1,
                           pass3_ms=dev_ms(lambda: run(4), 10))
            emit("vk_kernel", nvidia_smi=smi, **rec)
    chunked_srcs = [d for d in srcs if libs[d][1]]
    if not chunked_srcs:
        return
    fn = libs[chunked_srcs[0]][0]
    for label, thr, s0, nnz in cases:
        if label not in ("fhd_luma_chunk", "fhd_p_luma_b1", "cif_p_luma_b1"):
            continue
        sweep = []
        for chunk in (128, 256, 512, 1024, 2048):
            for warmup in (0, 128, 256, 512):
                for walkers in (64, 128, 256):
                    stats = torch.zeros(5, dtype=torch.int32, device=dev)
                    plan = (chunk, warmup, walkers)
                    srun, out = launcher(fn, True, thr, s0, nnz, plan,
                                         stats=stats)
                    srun()
                    torch.cuda.synchronize()
                    assert torch.equal(out, plain[label]), plan
                    live, met = stats.tolist()[:2]
                    run, _ = launcher(fn, True, thr, s0, nnz, plan)
                    sweep.append(dict(chunk=chunk, warmup=warmup,
                                      walkers=walkers, ms=dev_ms(run, 5),
                                      met_at_start=met / live,
                                      rows_rewalked=stats.tolist()[4]))
        best = min(sweep, key=lambda r: r["ms"])
        emit("vk_sweep", case=label, source=tags[chunked_srcs[0]], best=best,
             plans=sweep, nvidia_smi=smi)


PROBE_EVALS = (1, 4, 16, 64)   # the evaluation sweep of --probe


def _probe_lib(src_dir, out_dir, sass_path):
    """Build src_dir/probe_gang.cu under out_dir with ptxas's report;
    returns (C entry, whether it takes a launch shape, the report's
    lines, per kernel function its SASS instructions by opcode
    (cuobjdump -sass, whose listing goes to sass_path) or None where the
    toolkit has no cuobjdump)."""
    import collections
    import ctypes
    import re
    from dsv2_tpu_torch.ops import _kernels
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(src_dir, "probe_gang.cu")
    so = os.path.join(out_dir, "libprobe_gang.so")
    res = subprocess.run([_kernels._nvcc()] + _kernels.NVCC_FLAGS
                         + ["-Xptxas", "-v", "-o", so, src],
                         check=True, capture_output=True, text=True)
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    with open(src) as f:
        shaped = "int ctas, int warps" in f.read()
    fn = ctypes.CDLL(so).dsv2t_probe_gang
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, P, P, P, P] + [I] * (6 if shaped else 4) + [P]
    sass = None
    dump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    if os.path.exists(dump):
        out = subprocess.run([dump, "-sass", so], capture_output=True,
                             text=True).stdout
        with open(sass_path, "w") as f:
            f.write(out)
        sass, cur = {}, None
        for ln in out.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                cur = sass.setdefault(m.group(1), collections.Counter())
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                          ln)
            if cur is not None and m:
                cur[m.group(1)] += 1
        sass = {k: {op: n for op, n in v.items()
                    if op in ("LDS", "LDG", "SHFL", "STS", "STG", "BRA",
                              "SHF", "IMAD", "IADD3", "LDGSTS")}
                for k, v in sass.items()}
    return fn, shaped, ptxas, sass


def probe_study(srcs, out):
    """--probe: the gang cost probe's kernels of each source directory of
    `srcs` in turn (see the module docstring); the SASS listings go to
    out/probe_sass_<source>.txt."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from dsv2_tpu_torch.tools import probe_gang as pg
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    tags = {d: os.path.relpath(os.path.abspath(d), REPO) for d in srcs}

    os.makedirs(out, exist_ok=True)

    def build(d):
        tag = tags[d].replace(os.sep, "_")
        return d, _probe_lib(d, os.path.join(REPO, "build", "torch_profile",
                                             "probe_" + tag),
                             os.path.join(out, "probe_sass_%s.txt" % tag))
    with ThreadPoolExecutor(len(tags)) as ex:
        libs = dict(ex.map(build, list(tags)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plane, cx, cy = pg.inputs(device=dev)
    nb = cx.shape[0]
    want = {}
    for variant, plain in (("block", pg.block_plain),
                           ("gang", pg.gang_plain)):
        for mode in pg.MODES:
            want[variant, mode] = plain(mode, plane, cx, cy)
        emit("probe_plain", variant=variant, mode="full",
             ms=dev_ms(lambda: plain("full", plane, cx, cy), 10))
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(fn, shaped, variant, mode, walkers, evals=pg.EVALS):
        out = torch.zeros(nb, dtype=torch.int32, device=dev)
        args = [pg.VARIANTS.index(variant), pg.MODES.index(mode),
                plane.data_ptr(), cx.data_ptr(), cy.data_ptr(),
                out.data_ptr(), nb, evals, *plane.shape]
        if shaped:
            sh = pg.launch_shape(nb, variant, walkers, sms)
            args += [sh.ctas, sh.warps]
        args.append(stream)

        def run():
            assert fn(*args) == 0
        return run, out

    for d in srcs:
        fn, shaped, ptxas, sass = libs[d]
        ms, ns, equal = {}, {}, True
        for variant in pg.VARIANTS:
            for mode in pg.MODES:
                for w in (0, 1) if shaped else (1,):
                    run, out = launcher(fn, shaped, variant, mode, w)
                    run()
                    torch.cuda.synchronize()
                    equal &= torch.equal(out, want[variant, mode])
                    key = "%s_%s_w%d" % (variant, mode, w)
                    ms[key] = dev_ms(run, 20)
                    ns[key] = ms[key] * 1e6 / (nb * pg.EVALS)
        sweep = {}
        for variant in pg.VARIANTS:
            for w in (0, 1) if shaped else (1,):
                sweep["%s_full_w%d" % (variant, w)] = {
                    e: dev_ms(launcher(fn, shaped, variant, "full", w, e)[0],
                              20) for e in PROBE_EVALS}
        emit("probe_kernel", source=tags[d], shaped=shaped, equal=equal,
             ms=ms, ns_per_eval=ns, ms_by_evals=sweep, ptxas=ptxas,
             sass=sass, nvidia_smi=smi)
        assert equal, tags[d]


LOCKSTEP_PASSES = 3    # timed runs of each decode in --lockstep


IDLE_JOB = "torch_profile.job"     # the measured job's range in a trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def idle_by_span(path, window=IDLE_JOB, top=15):
    """Device idle time of a Chrome trace (torch.profiler's export with
    the port's spans as `user_annotation` ranges; their GPU-side copies,
    `gpu_user_annotation`, are not device work) inside the range named
    `window` (the whole trace where it has none): the gaps between the
    device intervals (as harness.read_profile's; the idle head and tail
    of the window apart: they are the job's start before its first
    device op and its end after its last, not waits between device
    work), each named by the shortest port span that covers it (over
    every thread) and, per thread, by that thread's shortest covering
    span; the head and tail named the same way; the gaps over 1 ms inside
    no span, by their start from the window's (ms) and length (ms)."""
    import bisect
    import collections
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, spans, win, main_tid = [], [], None, None
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur", 0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, t))
        elif cat == "user_annotation":
            if e["name"] == window:
                win, main_tid = (s, t), e["tid"]
            else:
                spans.append((s, t, e["name"], e["tid"]))
    if win is None:
        win = (min(s for s, _ in dev), max(t for _, t in dev))
    busy, gaps, first, end = 0.0, [], None, None
    for s, t in sorted(dev):
        s, t = max(s, win[0]), min(t, win[1])
        if t <= s or (end is not None and t <= end):
            continue
        if end is None:
            first = s
        elif s > end:
            gaps.append((end, s))
        busy += t - max(s, end if end is not None else s)
        end = t
    spans = [x for x in spans if x[1] > win[0] and x[0] < win[1]]
    spans.sort()
    starts = [x[0] for x in spans]
    first_span = {}
    for s, _, _, tid in spans:
        first_span.setdefault(tid, s)
    names = {tid: ("main" if tid == main_tid else "thread%d" % i)
             for i, tid in enumerate(sorted(first_span,
                                            key=first_span.get))}
    by_span = collections.Counter()
    by_thread = collections.defaultdict(collections.Counter)
    labelled, over_1ms, bare_1ms = [], 0, []

    def covering(g0, g1):
        """{tid: (length, name)} of each thread's shortest span over
        [g0, g1], and the shortest of them all (or "(no port span)")."""
        inner = {}
        for s, t, name, tid in spans[:bisect.bisect_right(starts, g0)]:
            if t >= g1 and (tid not in inner or t - s < inner[tid][0]):
                inner[tid] = (t - s, name)
        return inner, (min(inner.values())[1] if inner
                       else "(no port span)")
    for g0, g1 in gaps:
        inner, label = covering(g0, g1)
        dur = (g1 - g0) / 1e6
        by_span[label] += dur
        for tid, (_, name) in inner.items():
            by_thread[names[tid]][name] += dur
        labelled.append((dur, label))
        if dur > 1e-3:
            over_1ms += 1
            if not inner:
                bare_1ms.append(((g0 - win[0]) / 1e3, dur * 1e3))
    labelled.sort(reverse=True)
    head = (win[0], first if first is not None else win[1])
    tail = (end if end is not None else win[1], win[1])
    return dict(window_s=(win[1] - win[0]) / 1e6, busy_s=busy / 1e6,
                head_s=(head[1] - head[0]) / 1e6,
                head_span=covering(*head)[1],
                tail_s=(tail[1] - tail[0]) / 1e6,
                tail_span=covering(*tail)[1],
                gap_s=sum(d for d, _ in labelled), gaps=len(gaps),
                gaps_over_1ms=over_1ms,
                gaps_over_1ms_in_no_span=len(bare_1ms),
                bare_over_1ms=bare_1ms[:10],
                by_span=by_span.most_common(top),
                by_thread={k: v.most_common(5)
                           for k, v in sorted(by_thread.items())},
                longest=labelled[:10])


def idle_job(cell):
    """--idle-job: a warm job of the benchmark cell `cell`, then one job
    inside the range IDLE_JOB (run under DSV2_TRACE=1 DSV2_XPROF)."""
    import torch
    from codecbench import harness
    bench = harness.Bench(REPO)
    w = bench.cell(cell)
    cfg, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    entry = bench.entry(traffic["entry"])
    drv = entry.Driver(cfg, traffic, 7, torch.device("cuda"))
    drv.warm()
    torch.cuda.synchronize()
    with torch.profiler.record_function(IDLE_JOB):
        drv.job()
        torch.cuda.synchronize()


def idle_spans_study(trace_path=None):
    """--idle-spans: idle_by_span of one job of each cell, each traced in
    a process of its own (or of the trace at trace_path)."""
    import glob
    import shutil
    if trace_path:
        emit("idle_spans", trace=trace_path, **idle_by_span(trace_path))
        return
    for cell in ("cif_lockstep_encode_x8", "fhd_intra_encode"):
        d = os.path.join(REPO, "build", "torch_profile", "xprof_" + cell)
        shutil.rmtree(d, ignore_errors=True)
        env = dict(os.environ, DSV2_TRACE="1", DSV2_XPROF=d,
                   DSV2_TORCH_DEVICE="cuda")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--idle-job", cell], env=env,
                             capture_output=True, text=True)
        if res.returncode:
            sys.exit("idle job %s failed:\n%s" % (cell, res.stderr[-4000:]))
        path, = glob.glob(os.path.join(d, "*.trace.json"))
        t1 = time.perf_counter()
        emit("idle_spans", cell=cell, run_s=t1 - t0,
             trace_mb=os.path.getsize(path) / 2 ** 20,
             **idle_by_span(path), read_s=time.perf_counter() - t1)


def lockstep_study(pkgs, profile=False):
    """--lockstep: lockstep_run of each package root, one process each."""
    for root in pkgs:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--lockstep-run",
             os.path.abspath(root), str(int(profile))],
            capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        sys.stdout.flush()
        if res.returncode:
            sys.exit("lockstep run of %s failed:\n%s"
                     % (root, res.stderr[-4000:]))


def lockstep_run(root, profile):
    """The --lockstep measurements with the dsv2_tpu_torch of `root`."""
    import io
    import torch
    sys.path.insert(0, root)
    import dsv2_tpu_torch
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        dsv2_tpu_torch.__file__))) == root, dsv2_tpu_torch.__file__
    import torch_port_golden as golden
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.parallel import dynbatch
    from dsv2_tpu_torch.utils import trace, y4m
    from dsv2_tpu_torch.utils.packet import encode_eos
    dev = torch.device("cuda")
    gold = golden.load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def timed(fn, prof=False):
        """(wall s, fn(), stage seconds, device busy share or None) of one
        run; under torch.profiler if prof."""
        torch.cuda.synchronize()
        trace.reset()
        t0 = time.perf_counter()
        if prof:
            with torch.profiler.profile(activities=acts) as pr:
                out = fn()
                torch.cuda.synchronize()
        else:
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = kernel_busy_ms(pr)[0] / (wall * 1e3) if prof else None
        return wall, out, trace.totals(), busy

    def by(st, prefix):
        return {k[len(prefix):]: v for k, v in st.items()
                if k.startswith(prefix)}

    trace.enable(True)
    rec = dict(pkg=os.path.relpath(root, REPO), nvidia_smi=smi)
    trials = golden.corrupt_streams()

    def corrupt():
        n = 0
        for i, data in enumerate(trials):
            got = golden.decode_frames(decoder, y4m, data,
                                       decoder=decoder.Decoder(device=dev))
            assert got["frames"] == gold[golden.corrupt_key(i)]["frames"]
            n += len(got["frames"])
        return n
    corrupt()
    rec["corrupt_fps"] = [n / w for w, n, _, _ in
                          (timed(corrupt) for _ in range(LOCKSTEP_PASSES))]
    pkey = golden.p_key(golden.P_CASES[1])
    pstream = golden.read_stream(pkey)

    def p_decode():
        y = golden.decoded_y4m(decoder, y4m, pstream,
                               decoder=decoder.Decoder(device=dev))
        assert golden.digest(y) == gold[pkey]["decode"]
    p_decode()
    rec["cif_p_decode_fps"] = [golden.P_CASES[1][3] / timed(p_decode)[0]
                               for _ in range(LOCKSTEP_PASSES)]

    name, qp, gop, nlanes, per = golden.LOCKSTEP
    frames, meta = cli.read_y4m(golden.input_path(name))
    streams = [golden.lane_frames(frames, i) for i in range(nlanes)]
    del frames

    def factory():
        enc = cli.make_encoder(meta, cli.default_enc_opts(qp=qp, gop=gop),
                               device=dev)
        enc.hme_backend = "gang"
        return enc

    def encode(nfr=per):
        return dynbatch.encode_streams_lockstep(
            [st[:nfr] for st in streams], factory, width=nlanes)
    encode(2)
    wall, out, st, _ = timed(encode)
    assert [golden.digest(o)["sha256"] for o in out] == [
        gold[golden.lane_key(i)]["sha256"] for i in range(nlanes)]
    rec.update(lockstep_fps=nlanes * per / wall, lockstep_seconds=wall,
               dispatch_seconds=by(st, "lockstep.dispatch."),
               run_seconds=by(st, "lockstep.run."))
    if profile:
        rec["device_busy_share"] = timed(encode, prof=True)[3]
    try:
        from dsv2_tpu_torch.parallel import gop
    except ImportError:
        gop = None
    if gop is not None:
        data = b"".join(out) + encode_eos()

        def ls_decode():
            return gop.decode_gops_parallel(io.BytesIO(data), width=nlanes,
                                            device=dev)
        ls_decode()
        wall, fr, st, _ = timed(ls_decode)
        assert len(fr) == nlanes * per
        rec.update(lockstep_decode_fps=len(fr) / wall,
                   lockstep_decode_parse_seconds=st.get("decode.parse"),
                   lockstep_decode_dispatch_seconds=by(
                       st, "lockstep.dispatch."))
        if profile:
            rec["lockstep_decode_busy_share"] = timed(ls_decode,
                                                      prof=True)[3]
    emit("lockstep", **rec)


def scan_study(pkgs, seed):
    """--scan: scan_run of each package root, one process each."""
    for root in pkgs:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--scan-run",
             os.path.abspath(root), str(seed)],
            capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        sys.stdout.flush()
        if res.returncode:
            sys.exit("scan run of %s failed:\n%s"
                     % (root, res.stderr[-4000:]))


def scan_run(root, seed):
    """The --scan measurements with the dsv2_tpu_torch of `root`."""
    import hashlib
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    sys.path.insert(0, root)
    import dsv2_tpu_torch
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        dsv2_tpu_torch.__file__))) == root, dsv2_tpu_torch.__file__
    from codecbench import clip, program
    from dsv2_tpu_torch.codec.devsteps import blob_cap
    from dsv2_tpu_torch.ops import hzcc, scan_pl
    from dsv2_tpu_torch.parallel import batch
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(REPO, "codecbench", "configs",
                           "fhd420_qp60.json")) as f:
        cfg = json.load(f)
    program.prepare(dev)
    frames = clip.make_clip(cfg["width"], cfg["height"], NFRAMES,
                            cfg["subsamp"], seed)
    enc = program.encoder(cfg, 0, dev)
    ctx = batch._prep_chunk(enc, frames[:CHUNK])
    p = ctx["p"]
    xs, bds, qs = batch._chunk_inputs(enc, ctx)
    meta = program.meta(cfg)
    fn = batch._device_batch_fn(meta.width, meta.height, meta.subsamp,
                                p.blk_w, p.blk_h, p.lossless, p.do_psy,
                                ctx["analyze"])
    vs = fn(xs[0], xs[1], xs[2], bds, qs)[2]
    scatters = (torch.ops.aten.scatter_.src,
                torch.ops.aten.scatter_add_.default)

    class Capture(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in scatters:
                self.calls.append((func.__name__, args))
            return out

    planes = []
    for c in range(3):
        segs = tuple(hzcc.scan_segments(*ctx["pcfg"].cdims[c]))
        total = sum(n for n, _ in segs)
        blob = scan_pl.make_scan_blob(segs, blob_cap(total))
        with Capture() as cap:
            b, nb, fb = blob(vs[c])
        rows = [hashlib.sha256(b[i, :int(nb[i])].cpu().numpy().tobytes()
                               ).hexdigest() for i in range(b.shape[0])]
        t0 = time.perf_counter()
        blob(vs[c])
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        alone = []
        for name, (out, dim, idx, src) in cap.calls:
            dst = out.clone()
            op = getattr(dst, name.split(".")[0])
            ms = dev_ms(lambda: op(dim, idx, src), reps=10)
            n = idx.shape[1]
            rowbase = torch.arange(idx.shape[0], device=dev)[:, None] \
                * dst.shape[1]
            hits = torch.bincount((idx + rowbase).reshape(-1),
                                  minlength=dst.numel()).reshape(dst.shape)
            alone.append(dict(op=name, out=list(dst.shape), writes=n,
                              ms=ms, top_element_share=float(
                                  hits.max(dim=1).values.float().mean()) / n))
            del dst, hits
        planes.append(dict(
            plane=c, total=total, nonzero_share=float(
                (vs[c] != 0).float().mean()),
            blob_ms=dev_ms(lambda: blob(vs[c]), reps=10),
            enqueue_ms=enqueue_ms, scatters=alone,
            blob_sha256=hashlib.sha256("".join(rows).encode()).hexdigest(),
            nbytes=nb.tolist(), fallback=fb.tolist()))
        del cap
    emit("scan_chunk", root=root, seed=seed, frames=CHUNK,
         chunk_ms=dev_ms(lambda: fn(xs[0], xs[1], xs[2], bds, qs)),
         planes=planes, nvidia_smi=smi)

    def job():
        e = program.encoder(cfg, 0, dev)
        out = batch.encode_intra_batch(e, frames, chunk=CHUNK)
        out += e.end_of_stream()
        return b"".join(out)

    warm = job()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        data = job()
        torch.cuda.synchronize()
    assert data == warm
    words = {blob_cap(sum(n for n, _ in hzcc.scan_segments(*d))) // 4 + 1
             for d in ctx["pcfg"].cdims}
    split = {}
    for a in prof.key_averages(group_by_input_shape=True):
        if a.key not in ("aten::scatter_add_", "aten::scatter_"):
            continue
        v = getattr(a, "device_time_total", None)
        if v is None:
            v = getattr(a, "cuda_time_total", 0.0)
        shape = a.input_shapes[0] if a.input_shapes else []
        part = a.key
        if a.key == "aten::scatter_add_":
            part += (".emission" if len(shape) == 2 and shape[1] in words
                     else ".hvs_hist")
        split[part] = split.get(part, 0.0) + v / 1e3 / NFRAMES
    emit("scan_job", root=root, frames=NFRAMES,
         sha256=hashlib.sha256(data).hexdigest(), ms_per_frame=split,
         nvidia_smi=smi)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--lockstep-run"]:
        import torch
        sys.path.insert(0, os.path.join(REPO, "tools"))
        assert torch.cuda.is_available(), "needs an NVIDIA GPU"
        return lockstep_run(argv[1], bool(int(argv[2])))
    if argv[:1] == ["--scan-run"]:
        sys.path.insert(0, REPO)
        return scan_run(argv[1], int(argv[2]))
    if argv[:1] == ["--idle-job"]:
        sys.path.insert(0, REPO)
        return idle_job(argv[1])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    ap.add_argument("--wavefront", action="store_true",
                    help="only the filter wavefront kernel study")
    ap.add_argument("--phases", action="store_true",
                    help="only the filter kernel's cycles per phase")
    ap.add_argument("--hme", action="store_true",
                    help="only the base-level motion search's ms and cycles "
                    "per phase")
    ap.add_argument("--vk", action="store_true",
                    help="only the vk chain kernel: ms per source, per "
                    "pass, and the sweep of its plan")
    ap.add_argument("--probe", action="store_true",
                    help="only the gang cost probe kernels: ms per source "
                    "and launch shape, ms by evaluations, ptxas and SASS")
    ap.add_argument("--src", action="append",
                    help="with --hme, --vk or --probe: a directory of kernel "
                    "sources to study, in the order given (default: this "
                    "checkout's "
                    "dsv2_tpu_torch/csrc)")
    ap.add_argument("--hme-levels", default="all",
                    choices=("all", "upper", "base"),
                    help="with --hme: the levels to study")
    ap.add_argument("--lockstep", action="store_true",
                    help="only the lockstep encode and decode and the "
                    "decodes of chain steps, per package root")
    ap.add_argument("--scan", action="store_true",
                    help="only the scan blob of the FHD intra cell's "
                    "chunk and its scatters, per package root")
    ap.add_argument("--scan-seed", type=int, default=7,
                    help="with --scan: the cell clip's seed")
    ap.add_argument("--pkg", action="append",
                    help="with --lockstep or --scan: a checkout root holding "
                    "dsv2_tpu_torch/, in the order given (default: this "
                    "checkout)")
    ap.add_argument("--idle-spans", action="store_true",
                    help="only the card's idle time by port span of a "
                    "lockstep and an intra job")
    ap.add_argument("--idle-trace",
                    help="with --idle-spans: read this Chrome trace")
    ap.add_argument("--profile", action="store_true",
                    help="with --lockstep: also the device busy share of "
                    "a profiled lockstep encode and decode")
    args = ap.parse_args(argv)
    if args.idle_spans and args.idle_trace:
        return idle_spans_study(args.idle_trace)
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_profile: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    if args.wavefront:
        return wavefront_study()
    if args.phases:
        return wavefront_phases()
    if args.vk:
        return vk_study(args.src or [os.path.join(REPO, "dsv2_tpu_torch",
                                                   "csrc")])
    if args.lockstep:
        return lockstep_study(args.pkg or [REPO], args.profile)
    if args.scan:
        return scan_study(args.pkg or [REPO], args.scan_seed)
    if args.idle_spans:
        return idle_spans_study()
    if args.probe:
        return probe_study(args.src or [os.path.join(REPO, "dsv2_tpu_torch",
                                                      "csrc")], args.out)
    if args.hme:
        return hme_study(args.src or [os.path.join(REPO, "dsv2_tpu_torch",
                                                    "csrc")],
                         args.hme_levels)
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
    emit("layers", frames=CHUNK, **lay)

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
