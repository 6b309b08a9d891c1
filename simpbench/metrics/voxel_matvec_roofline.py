"""Share of its roofline that the hand `voxel_matvec` kernel reaches in the
traced episodes: the least time of every launch (its bytes at the card's
bandwidth, on the cell's fine grid, by the launch's storage dtype: see
roofline.py) over the launches' measured device time.  Published peaks at
700 W: read it beside the card's power limit."""

from simpbench.roofline import voxel_matvec_seconds


def _dtype(name):
    low = name.lower()
    if "bfloat16" in low:
        return "bfloat16"
    if "<float>" in low:
        return "float32"
    return None


def read(run):
    if run.trace is None:
        return None
    nels = run.cell.grid()
    bound = spent = 0.0
    for op in run.trace.ops:
        if "voxel_matvec" not in op.name:
            continue
        dtype = _dtype(op.name)
        if dtype is None:       # a launch this reckoning has no bound for
            return None
        bound += voxel_matvec_seconds(nels, dtype)[0]
        spent += op.dur / 1e6
    return 100.0 * bound / spent if spent else None
