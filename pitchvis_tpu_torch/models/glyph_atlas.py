"""Pitch-name glyph atlas for the rasterizer.

Port of ``pitchvis_tpu/models/glyph_atlas.py``. The reference viewer draws
the 12 pitch-class names ("C", "C♯", ... "B") as Bevy Text2d entities
around the spiral's outer ring: DejaVuSans at 40 px, center-justified,
scaled 0.02 into world units, colored with the pitch-class palette
(pitchvis_viewer/src/display_system/setup.rs:386-416). The glyph shapes
come from that typeface, baked into a small committed atlas
(``assets/pitch_name_atlas.npz``, a byte copy of the JAX package's) so the
rasterizer needs no font stack at render time.

Atlas format (npz):
* ``bitmap_XX``: uint8 coverage (h, w), rendered at ``ATLAS_FONT_PX`` (4x
  the reference's 40 px for downsampling headroom), one per pitch class XX
  in [0, 12).
* ``center_XX``: float32 (cx, cy), the text layout box's center in bitmap
  pixel coordinates (what Bevy's default ``Anchor::Center`` centers on the
  entity translation; the layout box is the advance width x the line box).

Regenerate with ``python -m pitchvis_tpu_torch.models.glyph_atlas`` (needs
PIL and a DejaVuSans.ttf; matplotlib bundles one). The committed atlas is
the source of truth.

Known approximation: Bevy lays text out with cosmic-text (line box 1.2 em
by default); the atlas centers on the FreeType ascent+descent line box
(~1.16 em for DejaVuSans), a vertical offset of ~0.02 em (<0.5 px at the
rendered size).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.colors import PITCH_NAMES

ATLAS_FONT_PX = 160  # 4x the reference's 40 px (setup.rs:394)
REFERENCE_FONT_PX = 40.0
ATLAS_PATH = os.path.join(os.path.dirname(__file__), "assets", "pitch_name_atlas.npz")


def build_atlas(out_path: str = ATLAS_PATH, font_path: str | None = None) -> dict:
    """Rasterizes the 12 pitch-name strings with FreeType (PIL) and writes
    the atlas npz. Returns the atlas dict (name -> array)."""
    from PIL import Image, ImageDraw, ImageFont

    if font_path is None:
        from matplotlib import font_manager

        font_path = font_manager.findfont("DejaVu Sans")
    font = ImageFont.truetype(font_path, ATLAS_FONT_PX)
    ascent, descent = font.getmetrics()
    line_h = ascent + descent
    arrays: dict[str, np.ndarray] = {}
    for i, name in enumerate(PITCH_NAMES):
        advance = int(np.ceil(font.getlength(name)))
        img = Image.new("L", (advance + 8, line_h + 8), 0)
        # baseline at `ascent`; +4 px margins keep AA tails unclipped
        ImageDraw.Draw(img).text((4, 4), name, fill=255, font=font)
        arrays[f"bitmap_{i:02d}"] = np.asarray(img, np.uint8)
        # layout-box center (advance x line box), in bitmap pixel coords
        arrays[f"center_{i:02d}"] = np.asarray([4.0 + advance / 2.0, 4.0 + line_h / 2.0], np.float32)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    return arrays


def load_atlas(path: str = ATLAS_PATH) -> list[tuple[np.ndarray, np.ndarray]] | None:
    """[(bitmap u8 (h, w), center (2,)) for each pitch class], or None if
    the atlas is missing (the rasterizer then skips the name ring and
    warns)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return [(z[f"bitmap_{i:02d}"], z[f"center_{i:02d}"]) for i in range(len(PITCH_NAMES))]


if __name__ == "__main__":
    atlas = build_atlas()
    sizes = [atlas[f"bitmap_{i:02d}"].shape for i in range(12)]
    print(f"wrote {ATLAS_PATH}: 12 glyphs, sizes {sizes}")
