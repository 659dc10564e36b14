from .store import TimeSeriesStore  # noqa: F401
from .weather import WeatherService  # noqa: F401
from . import transforms, ingest  # noqa: F401
