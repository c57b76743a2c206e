"""Host-side helpers of the port."""
import numpy as np


def to_numpy(a):
    """A tensor (detached, copied from its device) or an array-like as a
    numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
