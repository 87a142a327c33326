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
  ``tpurpn/kernels/nms_pallas.py::nms_pallas_keep``;
* ``prefix.prefix_pointwise`` and ``prefix.prefix_depthwise`` — replace no
  TPU kernel: the serving prefix's 1x1 and depthwise convolutions (which
  ``tpurpn`` left to XLA) with their bias, ReLU6 and residual fused;
* ``relpos_attention.relpos_attention`` — replaces no TPU kernel: ViTDet's
  attention cores with decomposed relative positions;
* ``mvit_pool.mvit_pool`` — replaces no TPU kernel: MViTv2's pooling of q,
  k and v (depthwise convs and LayerNorms) read in place from the qkv
  product;
* ``swin_attention.swin_attention`` — replaces no TPU kernel: Swin's
  shifted-window attention cores, reading the qkv product in grid order
  with the pad, roll, window cut, table bias and shift mask in their
  indexing.
"""
