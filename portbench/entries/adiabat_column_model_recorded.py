"""Entry: the adiabat column model's entry (:mod:`.adiabat_column_model`)
with the program's recording on for the traced call.

It differs in the traced call alone: ``trace()`` runs the adiabat entry's
own ``trace()`` inside ``clima_tpu_torch.utils.profiling.recording()``, so
that the program's spans (with their device markers) and its counters of
that call are recorded for the per-layer metrics that read them
(``portbench/metrics/_spans.py``), and the traced result gives the call's
columns (``columns``) for the metrics per column. The set-up, the window and
the check are the adiabat entry's, unchanged; recording is off in the
window.
"""

from __future__ import annotations

from portbench.entries import adiabat_column_model


class Cell(adiabat_column_model.Cell):
    """One run of a cell, as the adiabat entry's, with the traced call
    recorded by the program."""

    def trace(self, window_calls, window_s):
        from clima_tpu_torch.utils import profiling

        with profiling.recording():
            traced = super().trace(window_calls, window_s)
        return dict(traced, columns=self.mix["columns_per_call"])
