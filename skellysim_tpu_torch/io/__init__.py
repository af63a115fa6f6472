"""Trajectory, ensemble and listener I/O.

The listener client (`io.listener_client`) is exported here, as in the JAX
package: ``from skellysim_tpu_torch.io import Listener, Request``.
"""

from .listener_client import (Listener, Request, StreamlinesRequest,
                              VelocityFieldRequest)

__all__ = ["Listener", "Request", "StreamlinesRequest",
           "VelocityFieldRequest"]
