"""Flight recorder: always-on black-box capture + deterministic
offline replay (the third observability pillar after metrics and
traces — postmortem capture).

- :mod:`gigapaxos_tpu_torch.blackbox.recorder` — the bounded per-node
  capture ring and its trigger-dump plumbing (``PC.BLACKBOX_*``).
- :mod:`gigapaxos_tpu_torch.blackbox.capture` — the ``.gpbb`` file
  format.
- :mod:`gigapaxos_tpu_torch.blackbox.replay` — offline re-drive +
  bit-for-bit verification (``python -m gigapaxos_tpu_torch.blackbox
  replay``).
"""

from gigapaxos_tpu_torch.blackbox.capture import (CaptureError,
                                                  read_capture,
                                                  write_capture)
from gigapaxos_tpu_torch.blackbox.recorder import (BlackboxRecorder,
                                                   install_crash_hook)
from gigapaxos_tpu_torch.blackbox.replay import (render_report,
                                                 replay_capture)

__all__ = ["BlackboxRecorder", "CaptureError", "install_crash_hook",
           "read_capture", "render_report", "replay_capture",
           "write_capture"]
