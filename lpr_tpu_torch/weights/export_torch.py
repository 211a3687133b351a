"""Export an LPSR state back to a reference-compatible torch checkpoint
(counterpart of ``lpr_tpu/weights/export_torch.py``).

Round-trip interop: a model trained or converted here still loads with
the reference's loaders, whose ``inference/run.py:124-128`` expects the
full 158-tensor LPSR state dict, including the dead RDBs and the
duplicated shared-CSAR entries.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from lpr_tpu_torch.models.lpsr import LPSRConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def lpsr_to_torch_state_dict(state: Mapping[str, np.ndarray],
                             cfg: LPSRConfig = LPSRConfig()
                             ) -> Dict[str, torch.Tensor]:
    """An LPSR flat state -> the reference's exact state-dict layout:
    2 * num_blocks ``rdn.rdbs`` entries, the even ones the real RDBs (the
    dead ones zero-filled), the odd ones copies of the shared CSAR; the
    encoder and decoder again under ``auto_encoder.GA``, as the reference
    registers them twice."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(name, key, bias=True, src=state):
        sd[f"{name}.weight"] = _t(np.transpose(np.asarray(src[f"{key}/w"]),
                                               (3, 2, 0, 1)))
        if bias and f"{key}/b" in src:
            sd[f"{name}.bias"] = _t(src[f"{key}/b"])

    def dconv(name, key):
        conv(f"{name}.dConv.0", f"{key}/dw")
        conv(f"{name}.dConv.1", f"{key}/pw")

    def rdb(name, key, src):
        for i in range(cfg.num_layers):
            conv(f"{name}.layers.{i}.conv", f"{key}/layers/{i}", src=src)
        conv(f"{name}.lff", f"{key}/lff", src=src)
        sd[f"{name}.alpha"] = _t(src[f"{key}/alpha"]).reshape(())

    def csar(name):
        c = "rdn/csar"
        conv(f"{name}.conv_in.0", f"{c}/conv_in0")
        conv(f"{name}.conv_in.2", f"{c}/conv_in1")
        for key, i in (("ca_fc1", 2), ("ca_fc2", 4)):
            sd[f"{name}.ca.block.{i}.weight"] = _t(
                np.asarray(state[f"{c}/{key}/w"]).T)
            sd[f"{name}.ca.block.{i}.bias"] = _t(state[f"{c}/{key}/b"])
        conv(f"{name}.sa.block.0", f"{c}/sa_conv1")
        conv(f"{name}.sa.block.2", f"{c}/sa_conv2")
        conv(f"{name}.conv_out", f"{c}/conv_out")

    ae = "auto_encoder"
    conv(f"{ae}.conv_in", f"{ae}/conv_in", bias=False)
    for name, key in (("encoder.0", "enc0"), ("encoder.3", "enc1"),
                      ("decoder.0", "dec0"), ("decoder.3", "dec1")):
        dconv(f"{ae}.{name}", f"{ae}/{key}")
    conv(f"{ae}.conv_out", f"{ae}/conv_out", bias=False)
    # the reference registers encoder/decoder AGAIN inside ``GA =
    # Sequential(encoder, decoder)``, duplicating their keys
    for name, key in (("GA.0.0", "enc0"), ("GA.0.3", "enc1"),
                      ("GA.1.0", "dec0"), ("GA.1.3", "dec1")):
        dconv(f"{ae}.{name}", f"{ae}/{key}")

    conv("rdn.shallowF1", "rdn/shallowF1")
    conv("rdn.shallowF2", "rdn/shallowF2")
    csar("rdn.csar")
    r0 = "rdn/rdbs/0/"
    zero = {k: np.zeros_like(v) for k, v in state.items() if k.startswith(r0)}
    for i in range(cfg.num_blocks):
        # executed RDBs sit at even indices 0, 2; the later ones are dead
        if i < cfg.executed_rdbs:
            rdb(f"rdn.rdbs.{2 * i}", f"rdn/rdbs/{i}", state)
        else:
            rdb(f"rdn.rdbs.{2 * i}", "rdn/rdbs/0", zero)
        csar(f"rdn.rdbs.{2 * i + 1}")
    conv("rdn.gff.0", "rdn/gff0")
    conv("rdn.gff.1", "rdn/gff1")
    conv("final_conv", "final_conv")
    return sd


def save_lpsr_torch(path: str, state: Mapping[str, np.ndarray],
                    cfg: LPSRConfig = LPSRConfig()) -> None:
    """``torch.save`` of :func:`lpsr_to_torch_state_dict`: a plain state
    dict that the reference's ``LPSR.load_state_dict`` takes."""
    torch.save(lpsr_to_torch_state_dict(state, cfg), path)
