"""Serving: the inference engine (buckets, the fused and scan routes,
replicas over a mesh) and the HTTP server.  The names load on first use,
so importing ``serving.server`` alone does not build the engine's model
stack."""

from music_style_transfer_ldm_tpu_torch.utils.lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "EngineConfig": "engine", "InferenceEngine": "engine",
    "serve": "server"})
