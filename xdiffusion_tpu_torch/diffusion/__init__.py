"""Diffusion processes."""

from enum import Enum


class PredictionType(Enum):
    EPSILON = "epsilon"
    V = "v"
    RECTIFIED_FLOW = "rectified_flow"


def prediction_type_from_config(parameterization: str) -> PredictionType:
    key = parameterization.lower().replace("-", "_")
    if key == "epsilon":
        return PredictionType.EPSILON
    if key == "v":
        return PredictionType.V
    if key in ("rectified_flow", "rectifiedflow"):
        return PredictionType.RECTIFIED_FLOW
    raise NotImplementedError(f"Unknown parameterization {parameterization!r}")
