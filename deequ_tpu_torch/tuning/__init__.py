"""Tunable routing constants of the streaming service (:mod:`.knobs`).

The reference's calibration, profiles and online controller
(``deequ_tpu/tuning/``) are not ported (ROADMAP A6): every knob reads its
env override or its static default.
"""

from . import knobs

__all__ = ["knobs"]
