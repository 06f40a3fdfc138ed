from .bs import BitWriter, BitReader, ZBRLEWriter, ZBRLEReader  # noqa: F401
