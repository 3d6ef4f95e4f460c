"""Static analysis over the op-program IR (the port of ``repro.check``):
the :mod:`verifier` predicts per-op legality (bit-identical to the
engine's ``trace.ok``) plus derived reports without dispatching
anything; the :mod:`sanitizer` checks
:class:`~repro_torch.core.engine.DeviceState` invariants between
dispatches.  Pure numpy on host values.  :mod:`.lint` is the port's
AST lint (``python -m repro_torch.check.lint``), with the two rules of
``repro.check.lint`` that mean something without JAX.
"""

from repro_torch.check.sanitizer import (SanitizerError, assert_state,
                                         assert_states, check_state,
                                         check_states)
from repro_torch.check.verifier import (ERR_ACTIVE_LIMIT,
                                        ERR_ALLOC_INFEASIBLE, ERR_FULL,
                                        ERR_OVERFLOW, ERR_UNMAPPED_READ,
                                        OpVerdict, ProgramReport,
                                        explain_op, validate_rows,
                                        verify_program, verify_programs)

__all__ = [
    "ERR_ACTIVE_LIMIT", "ERR_ALLOC_INFEASIBLE", "ERR_FULL",
    "ERR_OVERFLOW", "ERR_UNMAPPED_READ", "OpVerdict", "ProgramReport",
    "SanitizerError", "assert_state", "assert_states", "check_state",
    "check_states", "explain_op", "validate_rows", "verify_program",
    "verify_programs",
]
