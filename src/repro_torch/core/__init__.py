"""repro_torch.core — TRQ quantizer, the cycle-accurate and closed-form
SAR-ADC models, the codebook-free output coding, the energy model and its
reports, per-layer registers and Algorithm-1 calibration
(``core.calibrate``, imported on its own: it depends on the ``trq_quant``
kernel)."""
from .trq import (TRQParams, make_params, trq_ad_ops, trq_quant,
                  trq_quant_ste, uniform_code, uniform_quant)
from .sar_adc import (sar_convert_trq, sar_convert_uniform, sar_search_trq,
                      sar_search_uniform)
from .coding import code_bits, decode, decode_index, encode, shift_add
from .energy import (E_OP_PJ, POWER_SHARES, R_ADC_DEFAULT, XBAR,
                     LayerEnergyReport, adc_energy_pj, conversions_per_mvm,
                     ideal_resolution, layer_report, mean_ops_trq,
                     mean_ops_uniform, model_adc_ratio,
                     system_power_breakdown, trq_op_ratio)
from .quant_state import (QUANT_STATE_VERSION, QuantState, load_quant_state,
                          quant_state_from_calibration,
                          quant_state_from_dict, quant_state_to_dict,
                          save_quant_state)
