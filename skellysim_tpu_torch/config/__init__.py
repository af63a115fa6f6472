from .schema import (BackgroundSource, Body, Config, ConfigEllipsoidal,
                     ConfigRevolution, ConfigSpherical, EllipsoidalPeriphery,
                     Fiber, Params, Point, RevolutionPeriphery,
                     SphericalPeriphery, load_config,
                     perturbed_fiber_positions)

__all__ = ["BackgroundSource", "Body", "Config", "ConfigEllipsoidal",
           "ConfigRevolution", "ConfigSpherical", "EllipsoidalPeriphery",
           "Fiber", "Params", "Point", "RevolutionPeriphery",
           "SphericalPeriphery", "load_config", "perturbed_fiber_positions"]
