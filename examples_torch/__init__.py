"""Runnable examples of the PyTorch/CUDA port, one for each of the JAX
package's examples (``examples/``) under the same module name. Each module
has ``main(device="cuda")``, returns what its twin's ``main()`` returns and
prints the same lines; ``python -m examples_torch.<name> [--device cpu]``
runs one (on the card unless ``--device cpu``)."""

from __future__ import annotations

import argparse


def run_main(main, argv=None):
    """The command line every example shares: ``--device`` (default
    ``cuda``; without a card the example raises)."""
    parser = argparse.ArgumentParser(description=(main.__module__ or "").rsplit(".", 1)[-1])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return main(device=parser.parse_args(argv).device)
