"""The link model's constants by role, shared by the parity tests that
hold the port's priced choices (AUTO, ``bucket_bytes = -1``,
``schedule_cost``, ``pred_s``, ``est_exchange_time_s``) to the JAX
package's. The port's constants describe an H100 host; under the
reference's constants, set on the port's module at run time, the port must
make the reference's choices exactly. Not collected itself."""
from repro.distributed import comm_model as jcm
from repro_torch.distributed import comm_model as tcm

#: the port's name of each constant -> the reference's name for that role
ROLES = {"PEAK_FLOPS": "PEAK_FLOPS", "HBM_BW": "HBM_BW",
         "NVLINK_BW_PER_LINK": "ICI_BW_PER_LINK",
         "NVLINK_LINKS": "ICI_LINKS", "NET_BW": "DCI_BW",
         "ALPHA_NVLINK": "ALPHA_ICI", "ALPHA_NET": "ALPHA_DCI",
         "OVERLAP_ALPHA_RESIDUE": "OVERLAP_ALPHA_RESIDUE"}


def use_reference_constants(monkeypatch) -> None:
    """Set each of the reference's constants on the port's module, read
    from ``repro.distributed.comm_model`` now."""
    for port_name, ref_name in ROLES.items():
        monkeypatch.setattr(tcm, port_name, getattr(jcm, ref_name))
