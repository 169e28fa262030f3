"""The 95th percentile, over every request due in the window, of the time
from when it was due on the open-loop schedule to when its output was
complete on the host; a request not done at the window's close counts at
its age then."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95))
