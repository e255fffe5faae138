"""pathway_tpu_torch.serving — the serving gateway and continuous batching.

Counterpart of ``pathway_tpu/serving/``. Between ``pw.io.http`` ingress
and the frontier runtime sit admission control (:mod:`.admission`:
per-route and per-tenant token buckets with a bounded queue; a refused
request gets 429 and a Retry-After), watermark backpressure
(:mod:`.backpressure`: shed or pace admission off the runtime's
watermark-lag gauges) and continuous batching of LLM decode
(:mod:`.continuous_batching`, the port's own, on the card). The first two
and the gateway that joins them are host code, copied from the JAX
package under the rename.

Entry point: ``ServingGateway`` passed to ``rest_connector(gateway=...)``
or to the ``xpacks.llm.servers`` REST servers.
"""

from pathway_tpu_torch.serving.admission import (
    AdmissionController,
    AdmissionDecision,
    TokenBucket,
)
from pathway_tpu_torch.serving.backpressure import WatermarkBackpressure
from pathway_tpu_torch.serving.continuous_batching import (
    ContinuousBatcher,
    continuous_batching_on,
)
from pathway_tpu_torch.serving.gateway import ServingGateway

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "ContinuousBatcher",
    "ServingGateway",
    "TokenBucket",
    "WatermarkBackpressure",
    "continuous_batching_on",
]
