"""Format constants of the frozen DSV2 v2.8 bitstream.

Mirrors the public header of the reference (ref: src/dsv.h:31-222); values
are part of the wire format and cannot change.
"""

FOURCC = b"DSV2"
VERSION_MINOR = 8

# Packet types (ref: src/dsv.h:38-45)
PT_META = 0x00
PT_PIC = 0x04
PT_EOS = 0x10


def make_pt(is_ref: int, has_ref: int) -> int:
    return PT_PIC | (int(bool(is_ref)) << 1) | int(bool(has_ref))


def pt_is_pic(t: int) -> bool:
    return bool(t & PT_PIC)


def pt_is_ref(t: int) -> bool:
    return (t & 0x6) == 0x6


def pt_has_ref(t: int) -> bool:
    return bool(t & 0x1)


PACKET_HDR_SIZE = 4 + 1 + 1 + 4 + 4
PACKET_TYPE_OFFSET = 5
PACKET_PREV_OFFSET = 6
PACKET_NEXT_OFFSET = 10

MIN_BLOCK_SIZE = 16
MAX_BLOCK_SIZE = 32
FRAME_BORDER = MAX_BLOCK_SIZE  # ref: src/dsv_internal.h:38

# Chroma subsampling codes (ref: src/dsv.h:80-95)
FMT_FULL_V = 0x0
FMT_DIV2_V = 0x1
FMT_DIV4_V = 0x2
FMT_FULL_H = 0x0
FMT_DIV2_H = 0x4
FMT_DIV4_H = 0x8

SUBSAMP_444 = FMT_FULL_H | FMT_FULL_V
SUBSAMP_422 = FMT_DIV2_H | FMT_FULL_V
SUBSAMP_UYVY = 0x10 | SUBSAMP_422
SUBSAMP_420 = FMT_DIV2_H | FMT_DIV2_V
SUBSAMP_411 = FMT_DIV4_H | FMT_FULL_V
SUBSAMP_410 = FMT_DIV4_H | FMT_DIV4_V


def fmt_h_shift(fmt: int) -> int:
    return (fmt >> 2) & 0x3


def fmt_v_shift(fmt: int) -> int:
    return fmt & 0x3


# Quantizer range (ref: src/dsv.h:221-222)
MAX_QP_BITS = 12
MAX_QP = (1 << MAX_QP_BITS) - 1

# Per-frame bitstream subsections of the motion data (ref: src/dsv_internal.h:31-36)
SUB_MODE = 0
SUB_MV_X = 1
SUB_MV_Y = 2
SUB_SBIM = 3
SUB_EPRM = 4
SUB_NSUB = 5

# Statistic marker indices (ref: src/dsv.h:153-160)
STABLE_STAT = 0
MAINTAIN_STAT = 1
RINGING_STAT = 2
MODE_STAT = 3
EPRM_STAT = 4
MAX_STAT = 5
ONE_MARKER = 0
ZERO_MARKER = 1

# Intra sub-block mask bits (ref: src/dsv.h:163-169)
MODE_INTER = 0
MODE_INTRA = 1
MASK_INTRA00 = 1
MASK_INTRA01 = 2
MASK_INTRA10 = 4
MASK_INTRA11 = 8
MASK_ALL_INTRA = MASK_INTRA00 | MASK_INTRA01 | MASK_INTRA10 | MASK_INTRA11

# Motion-vector flag bits (ref: src/dsv.h:184-191)
MV_BIT_INTRA = 0
MV_BIT_EPRM = 1
MV_BIT_MAINTAIN = 2
MV_BIT_SKIP = 3
MV_BIT_RINGING = 4
MV_BIT_NOXMITY = 5
MV_BIT_NOXMITC = 6
MV_BIT_SIMCMPLX = 7

SRC_DC_PRED = 0x100

# Per-block "blockdata" flag bits consumed by quant + filters
# (ref: src/dsv_internal.h:96-110)
STABLE_BIT = 0
MAINTAIN_BIT = 1
SKIP_BIT = 2
RINGING_BIT = 3
INTRA_BIT = 4
EPRM_BIT = 5
SIMCMPLX_BIT = 6

IS_STABLE = 1 << STABLE_BIT
IS_MAINTAIN = 1 << MAINTAIN_BIT
IS_SKIP = 1 << SKIP_BIT
IS_RINGING = 1 << RINGING_BIT
IS_INTRA = 1 << INTRA_BIT
IS_EPRM = 1 << EPRM_BIT
IS_SIMCMPLX = 1 << SIMCMPLX_BIT

NDIF_THRESH = 2 * 4  # ref: src/dsv.h:151

# Fixed point precision for stretching the block grid over a subband
# (ref: src/dsv_internal.h:141)
BLOCK_INTERP_P = 14

# Luma half-pel filters for motion compensation (ref: src/dsv_internal.h:127-138)
HP_SHF = 5
HP_ADD = 1 << (HP_SHF - 1)
ME_HP_SHF = 3
ME_HP_ADD = 1 << (ME_HP_SHF - 1)

# Encoder constants (ref: src/dsv_encoder.h)
GOP_INTRA = 0
GOP_INF = 2**31 - 1
MIN_EFFORT = 0
MAX_EFFORT = 10
RC_CRF = 0
RC_ABR = 1
RC_CQP = 2
MAX_PYRAMID_LEVELS = 5
RC_QUAL_SCALE = 4
MAX_QUALITY = 100
RC_QUAL_MAX = MAX_QUALITY * RC_QUAL_SCALE
RF_RESET = 256

PSY_ADAPTIVE_QUANT = 1 << 0
PSY_CONTENT_ANALYSIS = 1 << 1
PSY_I_VISUAL_MASKING = 1 << 2
PSY_P_VISUAL_MASKING = 1 << 3
PSY_ADAPTIVE_RINGING = 1 << 4
PSY_ALL = 0xFF


def user_qual_to_rc_qual(user: int) -> int:
    return user * RC_QUAL_SCALE


def temporal_mc(fno: int) -> int:
    return fno % 2
