"""Entry driver: `parallel.batch.encode_intra_batch`, every frame intra.

A job encodes the seeded clip of `frames` frames at `-gop` in chunks of
`chunk` frames to its end-of-stream packet, with a fresh encoder; every
job encodes the same clip again. Its output is the stream's bytes.

Check: every job's stream must equal the one the seed picks to judge;
that one is judged by the reference (`reference.check.encode_faults`):
its structure, and every picture decoded against its frame, the
pictures split over worker processes. The control is the program at the
configuration's `control_qp` in place of its `-qp`: pictures below the
quality the configuration states."""
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
        from dsv2_tpu_torch.parallel import batch
        enc = program.encoder(self.enc_cfg, self.traffic["gop"],
                              self.device)
        out = batch.encode_intra_batch(enc, self.clip,
                                       chunk=self.traffic["chunk"])
        out += enc.end_of_stream()
        return b"".join(out)

    def frames(self, out):
        return len(self.clip)

    def check(self, outputs, seed):
        rng = clip.sample_rng(seed)
        judged = outputs[int(rng.integers(len(outputs)))]
        n = len(self.clip)
        groups = check.split(range(n))
        parts = check.parallel(check.encode_faults, [
            (judged, {k: self.clip[k] for k in g}, n, self.cfg,
             self.traffic["gop"], True, i == 0)
            for i, g in enumerate(groups)])
        faults = sum(f for f, _ in parts)
        mses = [m for _, ms in parts for m in ms]
        differing = sum(o != judged for o in outputs)
        checks = {"stream_faults": faults, "jobs_differing": differing,
                  "luma_mse_max": max(mses) if mses else check.MSE_NONE}
        return checks, (faults > 0) + differing, {
            "pictures_judged": len(mses),
            "luma_mse_median": sorted(mses)[len(mses) // 2] if mses
            else None}
