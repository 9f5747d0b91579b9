"""repro_torch.pim — PIM execution backends and the weight-stationary plan.

``pim_mvm(x, w, trq, backend=...)`` runs one matmul on a named datapath
(``exact`` | ``fake_quant`` | ``pallas`` | ``bit_exact``) and returns
``PimOut(y, ad_ops)``;
``prepare_params`` programs a whole model once into a ``PimPlan``.
"""
from .backend import (PimOut, get_backend, list_backends, pim_mvm,
                      register_backend, use_backend)
from .crossbar import (PimConfig, auto_range_fit, bit_exact_mvm, bitplanes,
                       collect_bl_samples, fake_quant_mvm, group_activations,
                       group_weights, offset_encode, weight_planes)
from .plan import (LayerPlan, PimPlan, check_plan, prepare_linear,
                   prepare_params, quant_state_token, run_prepared)
