"""hloc-compatible reconstruction layer (port of `gim_tpu/hloc/`).

Mirrors the reference's hloc/ pipeline surface (SURVEY §2.6): exhaustive
pairing, SuperPoint+LightGlue sparse extract/match to h5, dense (DKM)
matching with cell-quantized keypoint aggregation, COLMAP database export
with fundamental verification on the card, and incremental mapping
(pycolmap when present, else the native mapper of `hloc/mapper.py`).
"""
