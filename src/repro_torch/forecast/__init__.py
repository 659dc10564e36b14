from .base import (ForecastModelBase, version_from_numpy,  # noqa: F401
                   version_to_numpy)
from .linear import LinearForecaster, lr_version_from_numpy  # noqa: F401
from .gam import GAMForecaster, gam_version_from_numpy  # noqa: F401
from .ann import ANNForecaster, ann_version_from_numpy  # noqa: F401
from .lstm import LSTMForecaster, lstm_version_from_numpy  # noqa: F401
from .transform_models import EnergyFromCurrentModel  # noqa: F401

PAPER_MODELS = {"LR": LinearForecaster, "GAM": GAMForecaster,
                "ANN": ANNForecaster, "LSTM": LSTMForecaster}
