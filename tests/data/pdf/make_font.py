"""Write this folder's font: DejaVu Sans cut to Latin-1 and Latin
Extended-A (U+0020-U+007E, U+00A0-U+017F), the text layer's font where a
machine has no system font (``chip_smoke.py``'s PDF check).

    python3 tests/data/pdf/make_font.py [/path/to/DejaVuSans.ttf]

Needs fontTools; the default source is the Debian package's
``/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf``.  The licence is in
LICENSE-DejaVu.txt beside the font.
"""

import os
import sys

from fontTools import subset
from fontTools.ttLib import TTFont

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
CODES = list(range(0x20, 0x7F)) + list(range(0xA0, 0x180))


def main() -> None:
    font = TTFont(sys.argv[1] if len(sys.argv) > 1 else SOURCE)
    subsetter = subset.Subsetter(subset.Options())
    subsetter.populate(unicodes=CODES)
    subsetter.subset(font)
    font.save(os.path.join(HERE, "DejaVuSans-Latin.ttf"))


if __name__ == "__main__":
    main()
