"""Device-side border extension, so reconstructed reference frames never
leave the device (ref: src/frame.c:357-410; host twin core/frame.py).

Port of `extend_plane_graph` from `dsv2_tpu/ops/framedev.py`, with
leading (frame) dimensions. The ME pyramid (`ds2x_luma_graph`,
`pyramid_graph`) belongs to P encode and is not ported yet (ROADMAP
item 9).
"""
import torch

from ..core import constants as K

B = K.FRAME_BORDER
SUBDIV = 4
_I32 = torch.int32


def _strip(vals, n):
    """4:1 box downsample of a 1-D edge (..., n) with remainder averaging
    (ref: src/frame.c:250-355; host twin core/frame.py:_strip)."""
    v = vals.to(_I32)
    ln = n & ~(SUBDIV - 1)
    rem = n & (SUBDIV - 1)
    main = (v[..., :ln].reshape(v.shape[:-1] + (-1, SUBDIV))
            .sum(dim=-1, dtype=_I32) + 2) >> 2
    if rem:
        tail = torch.div(v[..., ln:].sum(dim=-1, keepdim=True, dtype=_I32),
                         rem, rounding_mode="floor")
        main = torch.cat([main, tail], dim=-1)
    return main


def extend_plane_graph(vis, w, h):
    """Visible plane (..., h, w) -> bordered plane (..., h+2B, w+2B) uint8
    with the 32-px apron filled exactly like dsv_extend_frame
    (ref: src/frame.c:357-410)."""
    lead = vis.shape[:-2]
    dev = vis.device
    ls = _strip(vis[..., :, 0], h)
    rs = _strip(vis[..., :, w - 1], h)
    ts = _strip(vis[..., 0, :], w)
    bs = _strip(vis[..., h - 1, :], w)

    def cval(strip, dim):
        # dim < SUBDIV: the reference reads the zero byte before the strip
        # allocation (host twin core/frame.py:_extend_plane cval)
        i = (dim // SUBDIV) - 1
        return strip[..., i] if i >= 0 else torch.zeros(lead, dtype=_I32,
                                                        device=dev)

    tl = (ts[..., 0] + ls[..., 0] + 1) >> 1
    tr = (cval(ts, w) + rs[..., 0] + 1) >> 1
    bl = (cval(ls, h) + bs[..., 0] + 1) >> 1
    br = (cval(bs, w) + cval(rs, h) + 1) >> 1

    ridx = torch.arange(h, device=dev) // SUBDIV
    cidx = torch.arange(w, device=dev) // SUBDIV
    lcol = ls[..., ridx, None].expand(lead + (h, B))
    rcol = rs[..., ridx, None].expand(lead + (h, B))
    mid = torch.cat([lcol, vis.to(_I32), rcol], dim=-1)

    def row(c0, strip, c1):
        return torch.cat([c0[..., None].expand(lead + (B,)), strip[..., cidx],
                          c1[..., None].expand(lead + (B,))], dim=-1)

    top = row(tl, ts, tr)[..., None, :].expand(lead + (B, w + 2 * B))
    bot = row(bl, bs, br)[..., None, :].expand(lead + (B, w + 2 * B))
    return torch.cat([top, mid, bot], dim=-2).to(torch.uint8)
