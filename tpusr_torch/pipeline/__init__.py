"""The serving pipeline: SR -> patch-vote classification, the cascade, and the
micro-batching server."""

from tpusr_torch.pipeline.defect_pipeline import (FusedSRClassifyPipeline,
                                                  make_serving_pipeline)
from tpusr_torch.pipeline.serving import PipelineServer

__all__ = ["FusedSRClassifyPipeline", "PipelineServer", "make_serving_pipeline"]
