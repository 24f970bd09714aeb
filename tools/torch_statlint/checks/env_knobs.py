"""Check: the env-knob convention.

Every ``DEEQU_TPU_*`` knob read must (a) go through the shared
``utils.env_number``/``env_str``/``env_flag`` parsers (the warn-once,
keep-the-default convention) or live in ``config.py``/``utils.py``
themselves, and (b) be documented in the port's ``config.py``, the one
place an operator can discover every switch. The env overrides the tuning
registry (``tuning/knobs.py``) reads count as read. Custom parsers with richer
semantics (the watchdog's derived deadline, tri-state probes) are
deliberate and carry baseline entries instead of silent exemptions.
"""

from __future__ import annotations

from typing import List

from ..core import Finding, ModuleIndex, iter_env_reads, pkg, unresolved
from .tuning_registry import registered_envs

CHECK = "env-knob"

PREFIX = "DEEQU_TPU_"

CONFIG = pkg("config.py")

#: modules allowed to touch os.environ directly for DEEQU_TPU_* knobs
ALLOWED_SUFFIXES = (CONFIG, pkg("utils.py"))


def run(index: ModuleIndex) -> List[Finding]:
    findings: List[Finding] = []
    names_read = set(registered_envs(index))
    for module in index.modules:
        allowed = module.relpath.endswith(ALLOWED_SUFFIXES)
        for node, env_name, style in iter_env_reads(module):
            if env_name is None or not env_name.startswith(PREFIX):
                continue
            names_read.add(env_name)
            if style == "direct" and not allowed:
                findings.append(Finding(
                    check=CHECK, path=module.relpath, line=node.lineno,
                    message=(
                        f"direct os.environ read of {env_name}: go through "
                        "utils.env_number/env_str/env_flag (warn-once "
                        "convention) or baseline with a reason"
                    ),
                    key=f"direct:{env_name}",
                ))
    config = index.registry(CONFIG)
    if config is None:
        findings.append(unresolved(CHECK, CONFIG, f"registry {CONFIG}"))
        return findings
    for env_name in sorted(names_read):
        if env_name not in config.source:
            findings.append(Finding(
                check=CHECK, path=config.relpath, line=1,
                message=(
                    f"{env_name} is read in the package but not "
                    "documented in config.py (every operator-facing "
                    "knob must be discoverable there)"
                ),
                key=f"undocumented:{env_name}",
            ))
    return findings
