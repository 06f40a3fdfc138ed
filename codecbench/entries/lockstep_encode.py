"""Entry driver: `parallel.dynbatch.encode_streams_lockstep`, GOP-parallel
P encode with every device step batched over the lanes.

A job encodes `lanes` streams of `frames_per_lane` frames at `-gop`
(the seeded clip of lanes x frames_per_lane frames cut into consecutive
lanes) through one lockstep group of `width` lanes with the motion
search backend `hme_backend`; every job encodes the same lanes again.
Its output is the list of the lanes' streams (no end-of-stream packet).

Check: every job's lanes must equal those of the job the seed picks to
judge; of that job every lane is judged whole by the reference, each in
a worker process of its own. The control is the program at the
configuration's `control_qp` in place of its `-qp`: pictures below the
quality the configuration states."""
from codecbench import clip, program
from codecbench.reference import check

PRODUCES = "encode"


class Driver:
    def __init__(self, cfg, traffic, seed, device, control=False):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        program.prepare(device)
        self.lanes = program.lane_clips(cfg, traffic, seed)
        self.enc_cfg = dict(cfg, qp=cfg["control_qp"]) if control else cfg

    def warm(self):
        self.job()

    def job(self):
        return program.encode_lanes(self.enc_cfg, self.traffic, self.lanes,
                                    self.device)

    def frames(self, out):
        return sum(len(x) for x in self.lanes)

    def check(self, outputs, seed):
        rng = clip.sample_rng(seed)
        judged = outputs[int(rng.integers(len(outputs)))]
        n = len(self.lanes)
        parts = check.parallel(check.encode_faults, [
            (judged[i] if i < len(judged) else b"", dict(enumerate(lane)),
             len(lane), self.cfg, self.traffic["gop"], False)
            for i, lane in enumerate(self.lanes)])
        faults = sum(f for f, _ in parts) + abs(len(judged) - n)
        mses = [m for _, ms in parts for m in ms]
        differing = sum(o != judged for o in outputs)
        checks = {"stream_faults": faults, "jobs_differing": differing,
                  "luma_mse_max": max(mses) if mses else check.MSE_NONE}
        return checks, (faults > 0) + differing, {
            "pictures_judged": len(mses),
            "luma_mse_max_by_lane": [max(ms) if ms else None
                                     for _, ms in parts]}
