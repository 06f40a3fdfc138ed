"""Entry driver: `Encoder.encode_frame`, one stream encoded frame by
frame, as the CLI's `dsv2 e` encodes.

A job encodes the seeded clip of `frames` frames at `-gop` with a fresh
encoder (the CLI's default motion search backend, "auto": kernels 4/5 on
the card), one `encode_frame` call a frame in order, then its
end-of-stream packet; every job encodes the same clip again. Its output
is the stream's bytes.

Check: every job's stream must equal the one the seed picks to judge;
that one is judged whole by the reference (`reference.check.
encode_faults`): its structure, and every picture decoded in order
against its frame, in one worker process, since a P picture is decoded
on the one before it. The control is the program at the configuration's
`control_qp` in place of its `-qp`: pictures below the quality the
configuration states."""
from codecbench import clip, program
from codecbench.reference import check

PRODUCES = "encode"


class Driver:
    def __init__(self, cfg, traffic, seed, device, control=False):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        program.prepare(device)
        self.clip = clip.make_clip(cfg["width"], cfg["height"],
                                   traffic["frames"], cfg["subsamp"], seed)
        self.enc_cfg = dict(cfg, qp=cfg["control_qp"]) if control else cfg

    def warm(self):
        self.job()

    def job(self):
        enc = program.encoder(self.enc_cfg, self.traffic["gop"],
                              self.device)
        out = []
        for planes in self.clip:
            out += enc.encode_frame(planes)
        out += enc.end_of_stream()
        return b"".join(out)

    def frames(self, out):
        return len(self.clip)

    def check(self, outputs, seed):
        rng = clip.sample_rng(seed)
        judged = outputs[int(rng.integers(len(outputs)))]
        n = len(self.clip)
        (faults, mses), = check.parallel(check.encode_faults, [
            (judged, dict(enumerate(self.clip)), n, self.cfg,
             self.traffic["gop"], True)])
        differing = sum(o != judged for o in outputs)
        checks = {"stream_faults": faults, "jobs_differing": differing,
                  "luma_mse_max": max(mses) if mses else check.MSE_NONE}
        return checks, (faults > 0) + differing, {
            "pictures_judged": len(mses),
            "luma_mse_median": sorted(mses)[len(mses) // 2] if mses
            else None}
