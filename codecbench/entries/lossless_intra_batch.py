"""Entry driver: `parallel.batch.encode_intra_batch` at a lossless
quality, every frame intra.

A job is `entries/intra_batch.py`'s: the seeded clip of `frames` frames
at `-gop` in chunks of `chunk` frames to its end-of-stream packet, with a
fresh encoder; every job encodes the same clip again. Its output is the
stream's bytes.

Check: every job's stream must equal the one the seed picks to judge;
that one is judged by the lossless reference (`reference.lossless.
lossless_faults`): its structure, and every picture decoded and held
to its frame sample for sample on all three planes, the pictures split
over worker processes. The luma MSE is reported, not compared. The
control is the program at the configuration's `control_qp` in place of
its `-qp`: a lossy encode, whose pictures differ from their frames."""
from codecbench import clip
from codecbench.entries import intra_batch
from codecbench.reference import check, lossless

PRODUCES = "encode"


class Driver(intra_batch.Driver):
    def check(self, outputs, seed):
        rng = clip.sample_rng(seed)
        judged = outputs[int(rng.integers(len(outputs)))]
        n = len(self.clip)
        groups = check.split(range(n))
        parts = check.parallel(lossless.lossless_faults, [
            (judged, {k: self.clip[k] for k in g}, n, self.cfg,
             self.traffic["gop"], True, i == 0)
            for i, g in enumerate(groups)])
        faults = sum(f for f, _, _ in parts)
        samples = sum(s for _, s, _ in parts)
        mses = [m for _, _, ms in parts for m in ms]
        differing = sum(o != judged for o in outputs)
        checks = {"stream_faults": faults, "jobs_differing": differing,
                  "samples_differing": samples}
        return checks, (faults > 0) + differing + (samples > 0), {
            "pictures_judged": len(mses),
            "luma_mse_max": max(mses) if mses else check.MSE_NONE}
