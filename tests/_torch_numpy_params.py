"""Parameters for the parity tests, made with numpy at a seed in the
reference's layout: the keys and shapes of ``repro.models.transformer
.init_params`` (``jax.eval_shape``: nothing is computed), each leaf drawn
at its initializer's scale (Monarch ``L`` 1/sqrt(p) and ``R`` 1/sqrt(k),
dense ``w`` 1/sqrt(d_in), embedding tables 1/sqrt(d_model), a Mamba
layer's ``conv_w`` 1/sqrt(d_conv)).  Norm scales (a Mamba layer's
``norm_scale`` and ``D`` too) and biases (``conv_b``) are drawn around
their initial 1 and 0, so that each norm carries its own values (a
mixed-up pair of norms shows); ``A_log`` and ``dt_bias`` are drawn as the
reference's initializer draws them (A in [a_init_range], dt log-uniform
in [1e-3, 1e-1]).

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
        if name in ("scale", "norm_scale", "D"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "b", "conv_b"):
            v = 0.1 * rng.standard_normal(shape)
        elif name == "A_log":
            v = np.log(rng.uniform(*jcfg.ssm.a_init_range, shape))
        elif name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
            v = np.log(np.expm1(dt))
        else:
            fan = {"L": shape[-1], "R": shape[-1], "w": shape[-2],
                   "table": shape[-1], "unembed": shape[-2],
                   "conv_w": shape[-2]}[name]
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
