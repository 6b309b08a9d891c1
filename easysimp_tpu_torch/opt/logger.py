"""Per-iteration CSV logging and run summaries.

Format parity with src/Optimization/OptimizationLogger.jl: the CSV header
(OptimizationLogger.jl:26-29), per-row flush (:40-63), and the
`optimization_summary.txt` contents (:70-97).
"""

from __future__ import annotations

import os
import time
from datetime import datetime

__all__ = ["OptimizationLogger"]

_CSV_HEADER = (
    "Iteration,Energy,VolumeFraction,MaxDensityChange,"
    "LagrangeMultiplier,Grayness,MaxDisplacement\n"
)


class OptimizationLogger:
    def __init__(self, export_path: str, task_name: str = "SIMP_Optimization"):
        os.makedirs(export_path, exist_ok=True)
        self.export_path = export_path
        self.task_name = task_name
        self.start_time = time.time()
        self.iterations = 0
        self._csv_path = os.path.join(export_path, "optimization_progress.csv")
        self._csv = open(self._csv_path, "w")
        self._csv.write(_CSV_HEADER)
        self._csv.flush()

    def log_iteration(self, iteration, energy, volume_fraction, change,
                      lagrange_multiplier, grayness, max_displacement):
        self.iterations = iteration
        self._csv.write(
            f"{iteration},{energy:.10e},{volume_fraction:.8f},{change:.8e},"
            f"{lagrange_multiplier:.8e},{grayness:.6f},{max_displacement:.8e}\n"
        )
        self._csv.flush()

    def write_summary(self, final_energy, final_volume, converged):
        elapsed = time.time() - self.start_time
        path = os.path.join(self.export_path, "optimization_summary.txt")
        with open(path, "w") as fh:
            fh.write("SIMP Topology Optimization Summary\n")
            fh.write("=" * 40 + "\n")
            fh.write(f"Task name:        {self.task_name}\n")
            fh.write(f"Iterations:       {self.iterations}\n")
            fh.write(f"Wall time [s]:    {elapsed:.2f}\n")
            fh.write(f"Converged:        {converged}\n")
            fh.write(f"Final energy:     {final_energy:.10e}\n")
            fh.write(f"Final volume:     {final_volume:.10e}\n")
            fh.write(f"Timestamp:        {datetime.now().isoformat()}\n")

    def close(self):
        if not self._csv.closed:
            self._csv.close()
