# Message-matching engine + counters: the paper's second profiling
# method. A host-level model of the PRQ/UMQ matching path every MPI
# implementation contains, instrumented with lightweight counters, plus
# the point-to-point decomposition of the comm layer's collectives and
# two seeded, switchable defects for the detectors to find.
# A copy of ``repro.match``: the port imports nothing of the JAX
# package. Keep the two in step.
from .engine import (ANY_SOURCE, ANY_TAG, MODE_ALIASES, MODES, Fabric,
                     MatchEngine, Message, PostedRecv, canonical_mode)

__all__ = ["ANY_SOURCE", "ANY_TAG", "MODE_ALIASES", "MODES", "Fabric",
           "MatchEngine", "Message", "PostedRecv", "canonical_mode"]
