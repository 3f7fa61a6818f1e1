"""Parameters for the parity tests, made with numpy at a seed in the
reference's layout: the keys and shapes of ``repro.models.transformer
.init_params`` (``jax.eval_shape``: nothing is computed), each leaf drawn
at its initializer's scale (Monarch ``L`` 1/sqrt(p) and ``R`` 1/sqrt(k),
dense ``w`` 1/sqrt(d_in), embedding tables 1/sqrt(d_model)).  Norm scales
and biases are drawn around their initial 1 and 0, so that each norm
carries its own values (a mixed-up pair of norms shows).

The reference's own initializer takes ~15 s a model on the CPU for the
mixture-of-experts configs (its vmapped expert stacks compile primitive
by primitive); this takes well under a second.  Both packages get the
same arrays: ``jnp.asarray`` for the reference, ``params_from_numpy`` for
the port."""

import jax
import numpy as np

from repro.models import transformer as JT


def numpy_params(jcfg, seed: int = 0) -> dict:
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "b"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            fan = {"L": shape[-1], "R": shape[-1], "w": shape[-2],
                   "table": shape[-1], "unembed": shape[-2]}[name]
            v = rng.standard_normal(shape) / np.sqrt(fan)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both(jcfg, seed: int = 0):
    """(reference params, port params on the CPU) from one numpy tree."""
    import jax.numpy as jnp

    from repro_torch.convert import params_from_numpy

    npp = numpy_params(jcfg, seed)
    return (jax.tree_util.tree_map(jnp.asarray, npp),
            params_from_numpy(npp, device="cpu"))
