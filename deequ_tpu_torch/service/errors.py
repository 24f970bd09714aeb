"""Typed failure taxonomy of the continuous verification service.

Every job submitted to the service terminates with either a result or one
of these errors — never a bare exception and never a silent hang. The
split mirrors the engine-side metric taxonomy (`exceptions.py`):
callers branch on TYPE, not on message strings.
"""

from __future__ import annotations


class ServiceError(Exception):
    """Base of every service-plane failure."""


class ServiceOverloaded(ServiceError):
    """Admission control shed this job: the pending queue is at capacity.

    Raised AT SUBMIT TIME — load sheds instead of queueing unboundedly, so
    a burst degrades into fast typed rejections rather than an ever-growing
    queue whose tail jobs all blow their deadlines anyway."""

    def __init__(self, queue_depth: int, max_queue_depth: int):
        self.queue_depth = queue_depth
        self.max_queue_depth = max_queue_depth
        super().__init__(
            f"verification service overloaded: {queue_depth} jobs pending "
            f"(max {max_queue_depth}); retry with backoff or shed load"
        )


class QuotaExceeded(ServiceOverloaded):
    """A tenant exceeded ITS OWN admission budget (rows/s, bytes/s, or
    queue share — typically set from its catalog document), not the
    service-wide queue bound.

    Deliberately a :class:`ServiceOverloaded` subclass: every transport
    mapping that sheds overload typed (HTTP 429, retry-with-backoff
    guidance) applies unchanged — but the type carries WHICH tenant blew
    WHICH budget, so a flooding tenant reads its own name in the error
    instead of blaming the service. Raised AT ADMISSION after any bounded
    backpressure wait (``block_s``) expires; neighbors' admission is
    untouched."""

    def __init__(
        self, tenant: str, resource: str, limit: float, observed: float
    ):
        self.tenant = str(tenant)
        self.resource = str(resource)
        self.limit = float(limit)
        self.observed = float(observed)
        # the parent's queue-shaped attrs stay valid for callers that
        # branch on ServiceOverloaded without knowing about quotas
        self.queue_depth = 0
        self.max_queue_depth = 0
        Exception.__init__(
            self,
            f"tenant {tenant!r} over its {resource} quota "
            f"({observed:.6g} > {limit:.6g}); retry with backoff — "
            "neighbors are unaffected",
        )


class JobTimeout(ServiceError):
    """The job's deadline elapsed before a result was delivered.

    ``completed=False``: the job never ran (it aged out in the queue) or
    was cut short — no side effects. ``completed=True``: the job FINISHED,
    just past its deadline; its side effects (streaming state folds,
    repository saves) have committed and the result is reachable on the
    handle's ``late_value`` — do not blindly re-run such a job."""

    def __init__(
        self,
        job_id: str,
        deadline_s: float,
        waited_s: float,
        completed: bool = False,
    ):
        self.job_id = job_id
        self.deadline_s = deadline_s
        self.waited_s = waited_s
        self.completed = completed
        suffix = " (work completed late; side effects committed)" if completed else ""
        super().__init__(
            f"job {job_id} exceeded its {deadline_s:.3f}s deadline "
            f"({waited_s:.3f}s elapsed){suffix}"
        )


class TransientFailure(ServiceError):
    """A retryable failure (flaky feed link, contended device, injected
    fault). The scheduler retries with exponential backoff up to the job's
    retry budget; exhausting it converts the last failure into
    :class:`JobFailed`."""


class JobFailed(ServiceError):
    """Permanent job failure: a non-retryable error, or a transient one
    whose retry budget ran out. The original error rides ``__cause__``."""

    def __init__(self, job_id: str, attempts: int, cause: BaseException):
        self.job_id = job_id
        self.attempts = attempts
        super().__init__(
            f"job {job_id} failed permanently after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause}"
        )
        self.__cause__ = cause


class SessionClosed(ServiceError):
    """A micro-batch arrived for a streaming session that was closed."""

    def __init__(self, tenant: str, dataset: str):
        self.tenant = tenant
        self.dataset = dataset
        super().__init__(f"streaming session {tenant}/{dataset} is closed")


class ServiceClosed(ServiceError):
    """A job was submitted after the service shut down."""
