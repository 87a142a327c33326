"""Hand-written CUDA kernels of the port (``csrc/*.cu``, built at first use).

Each wrapper dispatches on its tensors' device: CPU tensors run the plain
PyTorch version in the same module, CUDA tensors launch the kernel (or
raise). ``<wrapper>.launches`` counts the kernel calls.

* ``proposal.fused_proposals`` — replaces
  ``tpurpn/kernels/proposal_pallas.py::fused_proposals_packed``;
* ``ir_stage.fused_ir_stage`` — replaces
  ``tpurpn/kernels/ir_stage_pallas.py::fused_ir_stage``;
* ``targets.fused_rpn_targets`` and ``targets.fused_iou_matching`` — replace
  ``tpurpn/kernels/target_pallas.py::fused_rpn_targets`` and
  ``::fused_iou_matching``;
* ``nms.nms_keep`` — replaces
  ``tpurpn/kernels/nms_pallas.py::nms_pallas_keep``.
"""
