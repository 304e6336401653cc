"""Faults planted under a run's timed path: each wraps the program's step."""


def stale(step):
    """A step that returns its state unchanged."""
    def broken(state, x):
        res = step(state, x)
        return res._replace(state=state, u0=state.U[:, 0])
    return broken


def half(step):
    """Half of the batch left out: its rows keep the state they came with.
    (No cell takes a mean over scenarios; the rows left out are the fault.)"""
    def broken(state, x):
        res = step(state, x)
        h = state.X.shape[0] // 2
        X, U = res.state.X.clone(), res.state.U.clone()
        X[h:], U[h:] = state.X[h:], state.U[h:]
        return res._replace(state=res.state._replace(X=X, U=U), u0=U[:, 0])
    return broken


def altered(step):
    """Answers altered where they are produced: every eighth scenario's
    command (a run compares a sample of the answers, so one altered answer
    shows only if it is drawn)."""
    def broken(state, x):
        res = step(state, x)
        U = res.state.U.clone()
        U[::8, 0, 1] += 0.05
        return res._replace(state=res.state._replace(U=U), u0=U[:, 0])
    return broken



def altered_latent(encoder):
    """One answer of the encoder altered where it is produced: frame 3's
    latent."""
    def broken(frames):
        z = encoder(frames).clone()
        z[3, 0] += 0.5
        return z
    return broken


altered_latent.target = "encoder"
ALL = (stale, half, altered)


def faults_of(cell: str, fault):
    """The fault as ``cell`` can have it: in the perception cell an altered
    answer is the encoder's (its widest u0 gap swings too far in sound runs
    for one altered command to show; PERF.md)."""
    return altered_latent if fault is altered and cell.startswith("c3_") else fault


def no_exchange(step):
    """The exchange between cards left out: every all-reduce a no-op."""
    import torch.distributed as dist

    def broken(state, x):
        real = dist.all_reduce
        dist.all_reduce = lambda *a, **k: None
        try:
            return step(state, x)
        finally:
            dist.all_reduce = real
    return broken
