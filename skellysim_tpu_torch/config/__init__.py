from .schema import (BackgroundSource, Config, Fiber, Params, Point,
                     load_config)

__all__ = ["BackgroundSource", "Config", "Fiber", "Params", "Point",
           "load_config"]
