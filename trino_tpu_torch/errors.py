"""Engine error taxonomy: Trino error codes + retryability.

Reference parity: core/trino-spi StandardErrorCode.java (the code space:
USER_ERROR from 0, INTERNAL_ERROR from 0x0001_0000, INSUFFICIENT_RESOURCES
from 0x0002_0000, EXTERNAL from 0x0100_0000) + TrinoException.java +
execution/ErrorCodes and the fault-tolerant execution retry predicate
(operator/RetryPolicy.java + FailureInfo classification in
execution/scheduler/faulttolerant/): only transient infrastructure failures
(worker/task loss, exchange transport) are retryable; analysis and semantic
errors never are.

Every engine-raised error either IS a TrinoError (carrying its ErrorCode)
or is mapped to one by `classify`, so the HTTP protocol layer, the query
tracker, and the retry machinery all agree on one taxonomy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

USER_ERROR = "USER_ERROR"
INTERNAL_ERROR = "INTERNAL_ERROR"
INSUFFICIENT_RESOURCES = "INSUFFICIENT_RESOURCES"
EXTERNAL = "EXTERNAL"


@dataclasses.dataclass(frozen=True)
class ErrorCode:
    """StandardErrorCode entry: stable name + numeric code + family."""

    name: str
    code: int
    type: str
    retryable: bool = False


# ----------------------------------------------------------- USER_ERROR (0x0)
GENERIC_USER_ERROR = ErrorCode("GENERIC_USER_ERROR", 0, USER_ERROR)
SYNTAX_ERROR = ErrorCode("SYNTAX_ERROR", 1, USER_ERROR)
USER_CANCELED = ErrorCode("USER_CANCELED", 3, USER_ERROR)
NOT_FOUND = ErrorCode("NOT_FOUND", 5, USER_ERROR)
FUNCTION_NOT_FOUND = ErrorCode("FUNCTION_NOT_FOUND", 6, USER_ERROR)
DIVISION_BY_ZERO = ErrorCode("DIVISION_BY_ZERO", 8, USER_ERROR)
NOT_SUPPORTED = ErrorCode("NOT_SUPPORTED", 13, USER_ERROR)
INVALID_SESSION_PROPERTY = ErrorCode("INVALID_SESSION_PROPERTY", 14,
                                     USER_ERROR)
SUBQUERY_MULTIPLE_ROWS = ErrorCode("SUBQUERY_MULTIPLE_ROWS", 28, USER_ERROR)

# ----------------------------------------------------- INTERNAL_ERROR (0x10000)
GENERIC_INTERNAL_ERROR = ErrorCode("GENERIC_INTERNAL_ERROR", 65536,
                                   INTERNAL_ERROR)
PAGE_TRANSPORT_ERROR = ErrorCode("PAGE_TRANSPORT_ERROR", 65539,
                                 INTERNAL_ERROR, retryable=True)
NO_NODES_AVAILABLE = ErrorCode("NO_NODES_AVAILABLE", 65541, INTERNAL_ERROR,
                               retryable=True)
REMOTE_TASK_ERROR = ErrorCode("REMOTE_TASK_ERROR", 65542, INTERNAL_ERROR,
                              retryable=True)
COMPILER_ERROR = ErrorCode("COMPILER_ERROR", 65543, INTERNAL_ERROR)
# the fleet's engine process is down (crashed or restarting): retryable —
# the supervisor respawns it, so a client retry lands on the replacement
ENGINE_UNAVAILABLE = ErrorCode("ENGINE_UNAVAILABLE", 65544, INTERNAL_ERROR,
                               retryable=True)
# poison-statement quarantine (fleet/supervisor.py): this statement's
# digest was in flight across K crash-correlated engine restarts, so
# workers fast-fail it for the quarantine TTL. NOT retryable — a replay
# is exactly what would crash-loop the engine again.
STATEMENT_QUARANTINED = ErrorCode("STATEMENT_QUARANTINED", 65546,
                                  INTERNAL_ERROR)

# ------------------------------------------------------- EXTERNAL (0x1000000)
# a lake read failed content verification (checksum mismatch, torn
# manifest/pointer, undecodable file): the bytes on storage are wrong,
# which no re-run fixes — NOT retryable. Detection is the contract:
# corruption classifies here instead of surfacing as a decode crash or,
# worse, silently wrong rows.
LAKE_DATA_CORRUPTION = ErrorCode("LAKE_DATA_CORRUPTION", 16777216, EXTERNAL)

# --------------------------------------------- INSUFFICIENT_RESOURCES (0x20000)
GENERIC_INSUFFICIENT_RESOURCES = ErrorCode(
    "GENERIC_INSUFFICIENT_RESOURCES", 131072, INSUFFICIENT_RESOURCES)
EXCEEDED_GLOBAL_MEMORY_LIMIT = ErrorCode(
    "EXCEEDED_GLOBAL_MEMORY_LIMIT", 131073, INSUFFICIENT_RESOURCES)
QUERY_QUEUE_FULL = ErrorCode("QUERY_QUEUE_FULL", 131074,
                             INSUFFICIENT_RESOURCES)
EXCEEDED_TIME_LIMIT = ErrorCode("EXCEEDED_TIME_LIMIT", 131075,
                                INSUFFICIENT_RESOURCES)
# retryable (the ONLY retryable resource error): the low-memory killer's
# victim may succeed once the node pool pressure clears, so
# retry_policy=QUERY transparently re-runs it (the reference's
# ClusterMemoryManager + TotalReservationLowMemoryKiller contract)
CLUSTER_OUT_OF_MEMORY = ErrorCode("CLUSTER_OUT_OF_MEMORY", 131076,
                                  INSUFFICIENT_RESOURCES, retryable=True)
EXCEEDED_LOCAL_MEMORY_LIMIT = ErrorCode(
    "EXCEEDED_LOCAL_MEMORY_LIMIT", 131079, INSUFFICIENT_RESOURCES)
# spill partition stores exhausted their host-RAM byte budget
# (`spill_max_bytes`): NOT retryable — a re-run would spill the same
# bytes again (the reference's ExceededSpillLimitException contract)
EXCEEDED_SPILL_LIMIT = ErrorCode(
    "EXCEEDED_SPILL_LIMIT", 131078, INSUFFICIENT_RESOURCES)


class TrinoError(Exception):
    """TrinoException analog: an exception carrying its ErrorCode.

    Subclasses pin a default via CODE; an instance-level override lets one
    class serve several codes (the server's admission errors)."""

    CODE: ErrorCode = GENERIC_INTERNAL_ERROR

    def __init__(self, message: str, code: Optional[ErrorCode] = None):
        super().__init__(message)
        self.code = code or type(self).CODE

    @property
    def error_name(self) -> str:
        return self.code.name

    @property
    def error_code(self) -> int:
        return self.code.code

    @property
    def error_type(self) -> str:
        return self.code.type

    @property
    def retryable(self) -> bool:
        return self.code.retryable


class QueryCanceledError(TrinoError):
    """Raised at a cooperative checkpoint after a DELETE/cancel request."""

    CODE = USER_CANCELED


class QueryTimeoutError(TrinoError):
    """query_max_run_time / query_max_execution_time exceeded."""

    CODE = EXCEEDED_TIME_LIMIT


class InjectedFault(TrinoError):
    """Synthetic fault from the chaos harness (exec/faults.py): models a
    lost worker/task, so it classifies retryable like REMOTE_TASK_ERROR."""

    CODE = REMOTE_TASK_ERROR


class ExchangeTransportError(TrinoError):
    """Transient failure moving pages across a fragment boundary."""

    CODE = PAGE_TRANSPORT_ERROR


class QueryQueueFullError(TrinoError):
    CODE = QUERY_QUEUE_FULL


class LakeDataCorruptionError(TrinoError):
    """A lake read (data file, row group, manifest, or pointer) failed
    content verification. The message carries the file path so an
    operator can go straight from the error to `lake_fsck`."""

    CODE = LAKE_DATA_CORRUPTION


class StatementQuarantinedError(TrinoError):
    """Fast-fail for a statement digest the fleet supervisor attributed
    K crash-correlated engine restarts to (bounded quarantine TTL)."""

    CODE = STATEMENT_QUARANTINED


class InvalidSessionPropertyError(TrinoError, KeyError):
    """KeyError-compatible (pre-taxonomy callers `except KeyError`)."""

    CODE = INVALID_SESSION_PROPERTY

    def __str__(self) -> str:  # bypass KeyError's repr-quoting
        return Exception.__str__(self)


def classify(exc: BaseException) -> ErrorCode:
    """Map any exception to its ErrorCode (TrinoException wrapping rule:
    unknown exceptions become GENERIC_INTERNAL_ERROR)."""
    if isinstance(exc, TrinoError):
        # covers every engine class: ParsingError, SemanticError,
        # ExecutionError, and ExceededMemoryLimitError all derive from
        # TrinoError and carry their own codes
        return exc.code
    if isinstance(exc, KeyError):
        # engine KeyErrors name missing functions/catalogs/columns — user
        # addressing errors, not engine bugs
        return NOT_FOUND
    if isinstance(exc, ZeroDivisionError):
        return DIVISION_BY_ZERO
    return GENERIC_INTERNAL_ERROR


def is_retryable(exc: BaseException) -> bool:
    """The RetryPolicy predicate: may re-running the failed task/query
    succeed? Injected faults and exchange transport are transient; user,
    semantic, resource, and unclassified internal errors are not."""
    return classify(exc).retryable
