"""``python -m cook_tpu_torch --config cook.json [--device cuda|cpu]`` — the
node entry point, the port's copy of ``cook_tpu/__main__.py`` (reference:
scheduler/src/cook/components.clj:345-365 -main)."""

import sys

from .daemon import main

if __name__ == "__main__":
    sys.exit(main())
