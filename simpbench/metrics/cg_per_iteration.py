"""CG iterations per SIMP iteration over the whole window: the program's
own count, returned by each step."""


def read(run):
    return sum(run.cg) / len(run.cg) if run.cg else None
