"""Interactive scene viewer (port of
vicasplat_tpu/visualization/viewer_server.py): the standard library's HTTP
server and a self-contained WebGL1 page (no CDN; the same bytes as the JAX
package's page): GLB parsing, orbit/pan/zoom controls, POINTS + LINES
primitives with vertex colours.

Usage:
    python -m vicasplat_tpu_torch.visualization.viewer_server scene.glb [port]
or  serve_scene("outputs/demo/xyz_and_camera.glb", port=8642)
"""
from __future__ import annotations

import http.server
import pathlib
import threading

_PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>vicasplat viewer</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;left:10px;top:8px;opacity:.8;pointer-events:none}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</div>
<canvas id="c"></canvas>
<script>
"use strict";
// ---- minimal GLB parser (JSON + single BIN chunk) ----
async function loadGLB(url){
  const buf = await (await fetch(url)).arrayBuffer();
  const dv = new DataView(buf);
  if (dv.getUint32(0, true) !== 0x46546C67) throw "not glb";
  const jlen = dv.getUint32(12, true);
  const json = JSON.parse(new TextDecoder().decode(new Uint8Array(buf, 20, jlen)));
  let off = 20 + jlen;
  let bin = null;
  while (off < dv.getUint32(8, true)) {
    const clen = dv.getUint32(off, true), ctype = dv.getUint32(off + 4, true);
    if (ctype === 0x004E4942) bin = new Uint8Array(buf, off + 8, clen);
    off += 8 + clen;
  }
  function accData(ai){
    const a = json.accessors[ai], v = json.bufferViews[a.bufferView];
    const start = (v.byteOffset||0) + (a.byteOffset||0);
    const n = a.count * {SCALAR:1, VEC3:3}[a.type];
    if (a.componentType === 5126) return new Float32Array(bin.buffer, bin.byteOffset + start, n);
    if (a.componentType === 5121) return new Uint8Array(bin.buffer, bin.byteOffset + start, n);
    if (a.componentType === 5125) return new Uint32Array(bin.buffer, bin.byteOffset + start, n);
    throw "component " + a.componentType;
  }
  const prims = [];
  for (const m of json.meshes) for (const p of m.primitives) {
    prims.push({
      mode: p.mode ?? 4,
      pos: accData(p.attributes.POSITION),
      col: p.attributes.COLOR_0 !== undefined ? accData(p.attributes.COLOR_0) : null,
      idx: p.indices !== undefined ? accData(p.indices) : null,
    });
  }
  return prims;
}
// ---- tiny matrix helpers ----
function mul(a,b){const o=new Float32Array(16);for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s}return o}
function persp(f,asp,n,fr){const t=1/Math.tan(f/2);return new Float32Array([t/asp,0,0,0, 0,t,0,0, 0,0,(fr+n)/(n-fr),-1, 0,0,2*fr*n/(n-fr),0])}
function lookAtOrbit(cx,cy,cz,az,el,r){
  const ex=cx+r*Math.cos(el)*Math.sin(az), ey=cy+r*Math.sin(el), ez=cz+r*Math.cos(el)*Math.cos(az);
  let zx=ex-cx,zy=ey-cy,zz=ez-cz; const zl=Math.hypot(zx,zy,zz); zx/=zl;zy/=zl;zz/=zl;
  let xx=zz, xy=0, xz=-zx; const xl=Math.hypot(xx,xy,xz)||1; xx/=xl;xz/=xl;
  const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
  return new Float32Array([xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
    -(xx*ex+xy*ey+xz*ez), -(yx*ex+yy*ey+yz*ez), -(zx*ex+zy*ey+zz*ez), 1]);
}
// ---- renderer ----
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
const vs = `attribute vec3 p; attribute vec3 c; uniform mat4 mvp; uniform float ps;
 varying vec3 vc; void main(){ gl_Position = mvp*vec4(p,1.); gl_PointSize = ps; vc = c; }`;
const fs = `precision mediump float; varying vec3 vc; void main(){ gl_FragColor = vec4(vc,1.); }`;
function shader(type, src){const s=gl.createShader(type);gl.shaderSource(s,src);gl.compileShader(s);
 if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(s);return s}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog,"p"), locC = gl.getAttribLocation(prog,"c");
const locM = gl.getUniformLocation(prog,"mvp"), locS = gl.getUniformLocation(prog,"ps");

let draws = [], center=[0,0,0], radius=3;
let az=0.6, el=0.3, dist=0, panX=0, panY=0;
loadGLB("scene.glb").then(prims => {
  let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  for (const pr of prims){
    const vb = gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, vb);
    gl.bufferData(gl.ARRAY_BUFFER, pr.pos, gl.STATIC_DRAW);
    let cb = null;
    if (pr.col){
      cb = gl.createBuffer();
      gl.bindBuffer(gl.ARRAY_BUFFER, cb);
      const f = pr.col instanceof Uint8Array ? Float32Array.from(pr.col, v=>v/255) : pr.col;
      gl.bufferData(gl.ARRAY_BUFFER, f, gl.STATIC_DRAW);
    }
    let ib = null, n = pr.pos.length/3;
    if (pr.idx){ ib = gl.createBuffer();
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ib);
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, new Uint16Array(pr.idx), gl.STATIC_DRAW);
      n = pr.idx.length; }
    draws.push({vb, cb, ib, n, mode: pr.mode===0?gl.POINTS:(pr.mode===1?gl.LINES:gl.TRIANGLES)});
    for (let i=0;i<pr.pos.length;i+=3) for(let k=0;k<3;k++){
      mn[k]=Math.min(mn[k],pr.pos[i+k]); mx[k]=Math.max(mx[k],pr.pos[i+k]); }
  }
  center=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  radius=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2])||1;
  dist=radius*1.6;
  document.title = "vicasplat viewer — " + draws.length + " primitives";
  frame();
});
function frame(){
  canvas.width = innerWidth*devicePixelRatio; canvas.height = innerHeight*devicePixelRatio;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.06,0.06,0.08,1); gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  const pm = persp(0.9, canvas.width/canvas.height, radius*0.01, radius*40);
  const vm = lookAtOrbit(center[0]+panX, center[1]+panY, center[2], az, el, dist);
  const mvp = mul(pm, vm);
  gl.uniformMatrix4fv(locM, false, mvp);
  gl.uniform1f(locS, Math.max(1.0, 2.0*devicePixelRatio));
  for (const d of draws){
    gl.bindBuffer(gl.ARRAY_BUFFER, d.vb);
    gl.enableVertexAttribArray(locP);
    gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
    if (d.cb){ gl.bindBuffer(gl.ARRAY_BUFFER, d.cb);
      gl.enableVertexAttribArray(locC);
      gl.vertexAttribPointer(locC, 3, gl.FLOAT, false, 0, 0);
    } else { gl.disableVertexAttribArray(locC); gl.vertexAttrib3f(locC, .9,.9,.9); }
    if (d.ib){ gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, d.ib);
      gl.drawElements(d.mode, d.n, gl.UNSIGNED_SHORT, 0);
    } else gl.drawArrays(d.mode, 0, d.n);
  }
  requestAnimationFrame(frame);
}
let drag=false, px=0, py=0, shift=false;
canvas.onmousedown = e => {drag=true; px=e.clientX; py=e.clientY; shift=e.shiftKey};
window.onmouseup = () => drag=false;
window.onmousemove = e => { if(!drag) return;
  const dx=e.clientX-px, dy=e.clientY-py; px=e.clientX; py=e.clientY;
  if (shift){ panX -= dx*dist*0.001; panY += dy*dist*0.001; }
  else { az -= dx*0.005; el = Math.max(-1.5, Math.min(1.5, el + dy*0.005)); } };
canvas.onwheel = e => { dist *= Math.exp(e.deltaY*0.001); e.preventDefault(); };
</script></body></html>
"""


class _Handler(http.server.BaseHTTPRequestHandler):
    glb_path: pathlib.Path = None

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            body = _PAGE.encode()
            ctype = "text/html"
        elif self.path == "/scene.glb":
            body = self.glb_path.read_bytes()
            ctype = "model/gltf-binary"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def serve_scene(glb_path, port: int = 8642, block: bool = True):
    """Serve the viewer for a GLB scene on 127.0.0.1:`port` (0 picks a free
    port: read it from the returned server's `server_address`). block=False
    returns the server, running on a daemon thread; stop it with
    `shutdown()` and `server_close()`."""
    handler = type("H", (_Handler,), {"glb_path": pathlib.Path(glb_path)})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), handler)
    if block:
        print(f"viewer: http://127.0.0.1:{port}/  (ctrl-c to stop)")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
        return None
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


if __name__ == "__main__":
    import sys

    serve_scene(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 8642)
