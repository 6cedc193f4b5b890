"""Interactive 3D map viewer: the MapDrawer analogue, as offline HTML.

Counterpart of object_slam_tpu/viz/map_viewer.py. The reference renders
the live map in a Pangolin GL window: map points, keyframe frusta,
covisibility graph + spanning tree + loop edges (MapDrawer.cc:83-178),
per-object colored points / centroid / AABB wireframe
(MapDrawer.cc:251-356), with Viewer menu toggles (Viewer.cc:79-82). Here a
self-contained HTML page (an inline canvas-2D renderer, no network) with
orbit/pan/zoom, the same layer toggles and a time slider that replays the
map's growth by each point's and keyframe's creation frame.

Usage:
    export_map_html(sys_.map, trajectory=sys_.trajectory,
                    path=out_dir + "/map.html")

Written by scripts/run_tum_torch.py / run_kitti_torch.py --viz-dir, next
to the scrubber's index.html.
"""

from __future__ import annotations

import json
import os

import numpy as np

from object_slam_tpu_torch.slam.map_state import covisibility
from object_slam_tpu_torch.viz.renderer import to_numpy


def _round3(a):
    return [[round(float(x), 3) for x in row] for row in np.asarray(a)]


def collect(m, trajectory, max_points: int = 40000, covis_min: int = 15):
    """The page's payload: the drawable subset of a MapState, as JSON
    types."""
    pt_valid = to_numpy(m.pt_valid)
    pt_xyz = to_numpy(m.pt_xyz)[pt_valid]
    pt_obj = to_numpy(m.pt_obj)[pt_valid]
    # time-slider key: the frame id at which the creating keyframe slot
    # was inserted (kf_frame_id), not the slot index, which culling
    # recycles
    all_kf_fid = to_numpy(m.kf_frame_id)
    pt_first_slot = to_numpy(m.pt_first_kf)[pt_valid]
    pt_first = np.where(pt_first_slot >= 0,
                        all_kf_fid[np.clip(pt_first_slot, 0, None)], -1)
    if pt_xyz.shape[0] > max_points:
        # deterministic decimation: keep every k-th in slab order
        step = int(np.ceil(pt_xyz.shape[0] / max_points))
        pt_xyz, pt_obj, pt_first = (pt_xyz[::step], pt_obj[::step],
                                    pt_first[::step])

    kf_valid = to_numpy(m.kf_valid)
    kf_ids = np.nonzero(kf_valid)[0]
    kf_pose = to_numpy(m.kf_pose)[kf_ids]            # Tcw
    kf_twc = np.linalg.inv(kf_pose)                  # camera-to-world
    kf_parent = to_numpy(m.kf_parent)[kf_ids]
    kf_loop = to_numpy(m.kf_loop_edge)[kf_ids]

    # covisibility edges of weight >= covis_min (MapDrawer.cc:126-145
    # draws the >= 100 graph; the page shows it as a layer)
    W = to_numpy(covisibility(m))
    id_of = {int(k): i for i, k in enumerate(kf_ids)}
    a_idx, b_idx = np.nonzero(np.triu(W, 1) >= covis_min)
    covis = [[id_of[a], id_of[b]] for a, b in zip(a_idx.tolist(),
                                                  b_idx.tolist())
             if a in id_of and b in id_of]

    obj_valid = to_numpy(m.obj_valid)
    obj_bbox = to_numpy(m.obj_bbox)
    obj_label = to_numpy(m.obj_label)
    obj_track = to_numpy(m.obj_track_id)
    obj_centroid = to_numpy(m.obj_centroid)
    objs = [{
        "label": int(obj_label[j]),
        "track": int(obj_track[j]),
        "slot": int(j),
        "centroid": [round(float(x), 3) for x in obj_centroid[j]],
        "bbox": [round(float(x), 3)
                 for x in np.asarray(obj_bbox[j], np.float64)],
    } for j in np.nonzero(obj_valid)[0]]

    traj = []
    for rec in trajectory or ():
        # FrameRecord-likes, (ts, Tcw, tracked) tuples, or Tcw rows
        T = getattr(rec, "Tcw", rec[1] if isinstance(rec, tuple) else rec)
        T = np.asarray(to_numpy(T), np.float64)
        C = -T[:3, :3].T @ T[:3, 3]
        traj.append([round(float(x), 3) for x in C])

    tree = [[i, id_of[int(p)]] for i, p in enumerate(kf_parent)
            if int(p) >= 0 and int(p) in id_of]
    loops = [[i, id_of[int(l)]] for i, l in enumerate(kf_loop)
             if int(l) >= 0 and int(l) in id_of]

    return {
        "pts": _round3(pt_xyz),
        "pt_obj": [int(x) for x in pt_obj],
        "pt_first": [int(x) for x in pt_first],
        "kf": [_round3(T) for T in kf_twc],
        "kf_id": [int(f) for f in all_kf_fid[kf_ids]],  # creation frames
        "tree": tree,
        "loops": loops,
        "covis": covis,
        "objs": objs,
        "traj": traj,
    }


_PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>object_slam_tpu map</title>
<style>
 body { background:#0b0b0e; color:#ccc; font:13px monospace; margin:0; }
 #hud { position:fixed; left:10px; top:8px; z-index:2; user-select:none; }
 #hud label { margin-right:10px; cursor:pointer; }
 #hud input[type=range] { vertical-align:middle; }
 canvas { display:block; }
 #info { position:fixed; right:10px; top:8px; color:#8c8; }
</style></head><body>
<div id="hud">
 <label><input type="checkbox" id="Lpts" checked> points</label>
 <label><input type="checkbox" id="Lkf" checked> keyframes</label>
 <label><input type="checkbox" id="Ltree" checked> spanning tree</label>
 <label><input type="checkbox" id="Lcov"> covisibility</label>
 <label><input type="checkbox" id="Lloop" checked> loop edges</label>
 <label><input type="checkbox" id="Lobj" checked> objects</label>
 <label><input type="checkbox" id="Ltraj" checked> trajectory</label>
 <br>time <input type="range" id="time" min="0" max="1000" value="1000">
 <span id="tlabel"></span>
</div>
<div id="info">drag: orbit &nbsp; shift-drag: pan &nbsp; wheel: zoom</div>
<canvas id="cv"></canvas>
<script>
const D = __DATA__;
const cv = document.getElementById('cv');
const ctx = cv.getContext('2d');
let yaw = -0.6, pitch = -0.35, dist0 = 1, target = [0,0,0];
// fit view to point cloud
(function(){
  const P = D.pts.length ? D.pts : D.traj;
  if (!P.length) return;
  let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  for (const p of P) for (let k=0;k<3;k++){
    mn[k]=Math.min(mn[k],p[k]); mx[k]=Math.max(mx[k],p[k]); }
  target = [(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  dist0 = Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1)*1.2;
})();
let dist = dist0;
const PAL = ['#e6194b','#3cb44b','#ffe119','#4363d8','#f58231','#911eb4',
             '#46f0f0','#f032e6','#bcf60c','#fabebe','#008080','#e6beff'];
function rot(){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  // camera looks along +z after rotation (y down, SLAM convention)
  return [[cy,0,-sy],[sy*sp,cp,cy*sp],[sy*cp,-sp,cy*cp]];
}
let R = rot();
function proj(p){
  const x=p[0]-target[0], y=p[1]-target[1], z=p[2]-target[2];
  const cx=R[0][0]*x+R[0][1]*y+R[0][2]*z;
  const cyy=R[1][0]*x+R[1][1]*y+R[1][2]*z;
  const cz=R[2][0]*x+R[2][1]*y+R[2][2]*z + dist;
  if (cz < 0.05*dist0) return null;
  const f = 1.2*Math.min(cv.width,cv.height);
  return [cv.width/2 + f*cx/cz, cv.height/2 + f*cyy/cz, cz];
}
function line(a,b,style,w){
  const pa=proj(a), pb=proj(b);
  if(!pa||!pb) return;
  ctx.strokeStyle=style; ctx.lineWidth=w||1;
  ctx.beginPath(); ctx.moveTo(pa[0],pa[1]); ctx.lineTo(pb[0],pb[1]);
  ctx.stroke();
}
function frustum(T, s, style){
  // KF camera-to-world 4x4; draw the MapDrawer pyramid (MapDrawer.cc:95)
  const o=[T[0][3],T[1][3],T[2][3]];
  const c=[[ s, 0.75*s, 1.5*s],[-s, 0.75*s, 1.5*s],
           [-s,-0.75*s, 1.5*s],[ s,-0.75*s, 1.5*s]];
  const w=c.map(v=>[
    T[0][0]*v[0]+T[0][1]*v[1]+T[0][2]*v[2]+o[0],
    T[1][0]*v[0]+T[1][1]*v[1]+T[1][2]*v[2]+o[1],
    T[2][0]*v[0]+T[2][1]*v[1]+T[2][2]*v[2]+o[2]]);
  for (let k=0;k<4;k++){ line(o,w[k],style); line(w[k],w[(k+1)%4],style); }
}
function aabb(bb, style){
  const [x0,y0,z0,x1,y1,z1]=bb;
  const c=[[x0,y0,z0],[x1,y0,z0],[x1,y1,z0],[x0,y1,z0],
           [x0,y0,z1],[x1,y0,z1],[x1,y1,z1],[x0,y1,z1]];
  const e=[[0,1],[1,2],[2,3],[3,0],[4,5],[5,6],[6,7],[7,4],
           [0,4],[1,5],[2,6],[3,7]];
  for (const [a,b] of e) line(c[a],c[b],style,1.5);
}
const maxKf = D.kf_id.length ? Math.max(...D.kf_id) : 0;
function draw(){
  R = rot();
  ctx.fillStyle='#0b0b0e'; ctx.fillRect(0,0,cv.width,cv.height);
  const tfrac = document.getElementById('time').value/1000;
  const tkf = Math.round(tfrac*maxKf);
  document.getElementById('tlabel').textContent =
    'kf <= ' + tkf + '/' + maxKf;
  if (document.getElementById('Lpts').checked){
    for (let i=0;i<D.pts.length;i++){
      if (D.pt_first[i] > tkf) continue;
      const s = proj(D.pts[i]);
      if (!s) continue;
      const o = D.pt_obj[i];
      ctx.fillStyle = o>=0 ? PAL[o%PAL.length] : '#9aa0b0';
      const r = o>=0 ? 2 : 1;
      ctx.fillRect(s[0]-r/2, s[1]-r/2, r, r);
    }
  }
  if (document.getElementById('Ltraj').checked && D.traj.length){
    ctx.strokeStyle='#d44'; ctx.lineWidth=1.5; ctx.beginPath();
    let started=false;
    const tn = Math.round(tfrac*(D.traj.length-1));
    for (let i=0;i<=tn;i++){
      const s=proj(D.traj[i]); if(!s){started=false;continue;}
      if(!started){ctx.moveTo(s[0],s[1]);started=true;}
      else ctx.lineTo(s[0],s[1]);
    }
    ctx.stroke();
  }
  if (document.getElementById('Ltree').checked)
    for (const [a,b] of D.tree){
      if (D.kf_id[a]>tkf||D.kf_id[b]>tkf) continue;
      line([D.kf[a][0][3],D.kf[a][1][3],D.kf[a][2][3]],
           [D.kf[b][0][3],D.kf[b][1][3],D.kf[b][2][3]],'#3a6',1);
    }
  if (document.getElementById('Lcov').checked)
    for (const [a,b] of D.covis){
      if (D.kf_id[a]>tkf||D.kf_id[b]>tkf) continue;
      line([D.kf[a][0][3],D.kf[a][1][3],D.kf[a][2][3]],
           [D.kf[b][0][3],D.kf[b][1][3],D.kf[b][2][3]],'#335',0.5);
    }
  if (document.getElementById('Lloop').checked)
    for (const [a,b] of D.loops){
      if (D.kf_id[a]>tkf||D.kf_id[b]>tkf) continue;
      line([D.kf[a][0][3],D.kf[a][1][3],D.kf[a][2][3]],
           [D.kf[b][0][3],D.kf[b][1][3],D.kf[b][2][3]],'#e44',2);
    }
  if (document.getElementById('Lkf').checked)
    for (let i=0;i<D.kf.length;i++){
      if (D.kf_id[i]>tkf) continue;
      frustum(D.kf[i], 0.02*dist0, '#58f');
    }
  if (document.getElementById('Lobj').checked)
    for (const ob of D.objs){
      const st = PAL[ob.slot%PAL.length];
      aabb(ob.bbox, st);
      const s = proj(ob.centroid);
      if (s){ ctx.fillStyle=st;
        ctx.fillText('L'+ob.label+' #'+ob.track, s[0]+4, s[1]-4);
        ctx.fillRect(s[0]-2,s[1]-2,4,4); }
    }
}
function resize(){ cv.width=innerWidth; cv.height=innerHeight; draw(); }
addEventListener('resize', resize);
let drag=null;
cv.onmousedown = e => drag=[e.clientX,e.clientY,e.shiftKey];
addEventListener('mouseup', ()=>drag=null);
addEventListener('mousemove', e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if (drag[2]){                       // pan in view plane
    const s = dist/(1.2*Math.min(cv.width,cv.height));
    target[0]-= s*(R[0][0]*dx+R[1][0]*dy);
    target[1]-= s*(R[0][1]*dx+R[1][1]*dy);
    target[2]-= s*(R[0][2]*dx+R[1][2]*dy);
  } else { yaw += dx*0.008; pitch += dy*0.008;
    pitch=Math.max(-1.55,Math.min(1.55,pitch)); }
  drag=[e.clientX,e.clientY,drag[2]]; draw();
});
cv.addEventListener('wheel', e=>{
  dist *= Math.exp(e.deltaY*0.001); e.preventDefault(); draw();
}, {passive:false});
document.querySelectorAll('#hud input').forEach(
  el=>el.addEventListener('input', draw));
resize();
</script></body></html>
"""


def export_map_html(m, trajectory=None, path: str = "map.html",
                    max_points: int = 40000, covis_min: int = 15) -> str:
    """Write the interactive map page; returns the path."""
    data = collect(m, trajectory, max_points, covis_min)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(_PAGE.replace("__DATA__", json.dumps(data)))
    return path
