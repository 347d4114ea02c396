"""Walkthroughs of the port on one device (counterparts of examples/*.py):
`gp_regression`, `orthogonalize_embeddings`, `spectral_analysis` and
`steady_state_transport`. Each `main(device=None)` runs on cuda:0 unless
it is given 'cpu', prints what the JAX package's example prints, checks
its bounds and returns its figures, each bound beside its figure as
`<figure>_bound` (the figure must be below it) or `<figure>_min` (above):

    python -m capital_tpu_torch.examples.gp_regression [cpu]
"""


def bounds_held(figs: dict) -> list:
    """[(figure, value, bound, held)] for every bound in an example's
    figures; held is False on NaN."""
    out = []
    for key, bound in figs.items():
        for suffix, holds in (("_bound", lambda v, b: v < b),
                              ("_min", lambda v, b: v > b)):
            if key.endswith(suffix):
                name = key[:-len(suffix)]
                out.append((name, figs[name], bound,
                            bool(holds(figs[name], bound))))
    return out
