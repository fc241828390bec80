"""The serving path: ServingPipeline.predict and its host-side pieces."""
