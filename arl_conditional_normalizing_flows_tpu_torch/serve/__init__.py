"""Serving entries and artifacts."""

from arl_conditional_normalizing_flows_tpu_torch.serve.export import (  # noqa: F401
    ImageServingFn,
    PipelinedSampler,
    ServingArtifact,
    export_multidraw_sampler,
    export_sampler,
    export_seeded_multidraw_sampler,
    load_artifact,
    make_image_serving_fn,
    make_multidraw_fn,
    make_seeded_multidraw_fn,
    save_artifact,
)
