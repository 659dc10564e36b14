from .base import ForecastModelBase  # noqa: F401
from .ann import ANNForecaster, ann_version_from_numpy  # noqa: F401
