"""repro_torch.core — TRQ quantizer, energy model, per-layer registers and
Algorithm-1 calibration (``core.calibrate``, imported on its own: it
depends on the ``trq_quant`` kernel)."""
from .trq import (TRQParams, make_params, trq_ad_ops, trq_quant,
                  trq_quant_ste, uniform_code, uniform_quant)
from .energy import (E_OP_PJ, R_ADC_DEFAULT, adc_energy_pj,
                     conversions_per_mvm, ideal_resolution, mean_ops_trq,
                     mean_ops_uniform, trq_op_ratio)
from .quant_state import (QUANT_STATE_VERSION, QuantState, load_quant_state,
                          quant_state_from_calibration,
                          quant_state_from_dict, quant_state_to_dict,
                          save_quant_state)
