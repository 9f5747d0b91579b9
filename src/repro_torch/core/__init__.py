"""repro_torch.core — TRQ quantizer, energy model and per-layer registers."""
from .trq import (TRQParams, make_params, trq_ad_ops, trq_quant,
                  trq_quant_ste, uniform_code, uniform_quant)
from .energy import E_OP_PJ, adc_energy_pj
from .quant_state import (QUANT_STATE_VERSION, QuantState, load_quant_state,
                          quant_state_from_dict, quant_state_to_dict,
                          save_quant_state)
