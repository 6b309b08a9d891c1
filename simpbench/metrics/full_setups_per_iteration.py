"""Full multigrid setups per SIMP iteration: the program's `setup.full`
counter (`VoxelStep.setup` without a previous state,
`easysimp_tpu_torch.tracing`) over its `steps` counter (SIMP iterations),
both as the process ends the window.  The cold traffic's schedule alone
gives 0.3 (full setups at iterations 1, 5 and 9 of each episode); what
lies above it is the CG watchdog's (`setup.watchdog`).  Like
`host_syncs_per_iteration` it counts every iteration the process ran, so
it is an episode's share only in a cell whose set-up runs no iteration.
None where the program keeps no such counter."""


def read(run):
    try:
        from easysimp_tpu_torch.tracing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("steps") or "setup.full" not in c:
        return None
    return c["setup.full"] / c["steps"]
