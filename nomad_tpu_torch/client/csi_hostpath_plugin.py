"""Hostpath CSI plugin as an EXTERNAL PROCESS (the upstream
csi-driver-host-path analog; ref plugins/csi/client.go — third-party CSI
drivers are separate processes behind the plugin boundary).

Drop an executable shim into the client's plugin_dir:

    #!/usr/bin/env python3
    from nomad_tpu.client.csi_hostpath_plugin import main
    main()

The volume base directory comes from $NOMAD_CSI_HOSTPATH_DIR (default
/opt/nomad-csi-hostpath). The same HostPathCSIPlugin class also runs
in-process for unit tests; this module is only the process boundary."""
from __future__ import annotations

import os


def main() -> None:
    from .csimanager import HostPathCSIPlugin
    from .plugin_runtime import serve_csi
    base = os.environ.get("NOMAD_CSI_HOSTPATH_DIR",
                          "/opt/nomad-csi-hostpath")
    serve_csi(HostPathCSIPlugin(base))


if __name__ == "__main__":
    main()
