"""repro_torch.pim — PIM execution backends and the weight-stationary plan.

``pim_mvm(x, w, trq, backend=...)`` runs one matmul on a named datapath
(``exact`` | ``fake_quant`` | ``pallas`` | ``bit_exact`` | ``noisy``) and
returns ``PimOut(y, ad_ops)``; ``ad_ops_tally`` opens the per-layer A/D
census; ``prepare_params`` programs a whole model once into a ``PimPlan``;
``CrossbarModel`` describes the device non-idealities the ``noisy``
backend injects; ``mapping`` lowers convolutions to crossbar MVMs (im2col)
and counts each layer's conversions.
"""
from .backend import (AdOpsTally, PimOut, active_backend, ad_ops_tally,
                      get_backend, list_backends, pim_mvm, register_backend,
                      use_backend)
from .crossbar import (PimConfig, auto_range_fit, bit_exact_mvm, bitplanes,
                       collect_bl_samples, fake_quant_mvm, group_activations,
                       group_weights, offset_encode, weight_planes)
from .mapping import LayerMapping, conv2d_pim, im2col, map_conv2d, \
    map_linear
from .plan import (LayerPlan, PimPlan, check_plan, prepare_linear,
                   prepare_params, quant_state_token, run_prepared)
# importing .noise registers the `noisy` backend and its prepare recipe
from .noise import (CrossbarModel, active_crossbar_model, crossbar_token,
                    is_noise_aware, register_noise_aware, use_crossbar_model)
# per-layer register state rides with the backend API (defined in core to
# keep the dependency direction core <- pim)
from ..core.quant_state import (QuantState, active_quant_state,
                                load_quant_state,
                                quant_state_from_calibration,
                                save_quant_state, use_quant_state)
