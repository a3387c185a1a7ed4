"""Legacy LES-postprocessing subsystem (VTK-free) — the port's copy of
``pods_digital_filter_tpu/postproc/``: numpy and scipy on the host, no
torch.

Re-design of the reference's secondary input path: instead of
synthesizing turbulence, sample planes out of existing LES volume snapshots
(or read ``inflow.%06i`` files) and feed them to the same POD + Fourier
compression stack.  Reference components: ``extract_plane`` (PODFS.py:515-581),
``save_Planes`` (623-852), ``save_instants`` (949-1041), ``write_vi_dat``
(584-621), ``GetPolarCoordinates`` (1087-1121), ``calculate_cell_volume``
(1124-1227), ``read_inflow_data`` (1230-1240).
"""
